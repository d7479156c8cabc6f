# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ilqr_debug.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from . import trajectory_pb2 as trajectory__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10ilqr_debug.proto\x12\x17quadrotorilqr_tpu.proto\x1a\x10trajectory.proto\"h\n\x16QuadrotorILQRIterDebug\x12@\n\ntrajectory\x18\x01 \x01(\x0b\x32,.quadrotorilqr_tpu.proto.QuadrotorTrajectory\x12\x0c\n\x04\x63ost\x18\x02 \x01(\x01\"Z\n\x12QuadrotorILQRDebug\x12\x44\n\x0biter_debugs\x18\x01 \x03(\x0b\x32/.quadrotorilqr_tpu.proto.QuadrotorILQRIterDebugb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ilqr_debug_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _QUADROTORILQRITERDEBUG._serialized_start=63
  _QUADROTORILQRITERDEBUG._serialized_end=167
  _QUADROTORILQRDEBUG._serialized_start=169
  _QUADROTORILQRDEBUG._serialized_end=259
# @@protoc_insertion_point(module_scope)
