# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: trajectory.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10trajectory.proto\x12\x17quadrotorilqr_tpu.proto\"*\n\x04Vec3\x12\n\n\x02\x63\x30\x18\x01 \x01(\x01\x12\n\n\x02\x63\x31\x18\x02 \x01(\x01\x12\n\n\x02\x63\x32\x18\x03 \x01(\x01\"6\n\x04Vec4\x12\n\n\x02\x63\x30\x18\x01 \x01(\x01\x12\n\n\x02\x63\x31\x18\x02 \x01(\x01\x12\n\n\x02\x63\x32\x18\x03 \x01(\x01\x12\n\n\x02\x63\x33\x18\x04 \x01(\x01\"N\n\x04Vec6\x12\n\n\x02\x63\x30\x18\x01 \x01(\x01\x12\n\n\x02\x63\x31\x18\x02 \x01(\x01\x12\n\n\x02\x63\x32\x18\x03 \x01(\x01\x12\n\n\x02\x63\x33\x18\x04 \x01(\x01\x12\n\n\x02\x63\x34\x18\x05 \x01(\x01\x12\n\n\x02\x63\x35\x18\x06 \x01(\x01\"8\n\x03SO3\x12\x31\n\nquaternion\x18\x01 \x01(\x0b\x32\x1d.quadrotorilqr_tpu.proto.Vec4\"i\n\x03SE3\x12\x32\n\x0btranslation\x18\x01 \x01(\x0b\x32\x1d.quadrotorilqr_tpu.proto.Vec3\x12.\n\x08rotation\x18\x02 \x01(\x0b\x32\x1c.quadrotorilqr_tpu.proto.SO3\"\x80\x01\n\x0eQuadrotorState\x12\x38\n\x12inertial_from_body\x18\x01 \x01(\x0b\x32\x1c.quadrotorilqr_tpu.proto.SE3\x12\x34\n\rbody_velocity\x18\x02 \x01(\x0b\x32\x1d.quadrotorilqr_tpu.proto.Vec6\"\x92\x01\n\x18QuadrotorTrajectoryPoint\x12\x0e\n\x06time_s\x18\x01 \x01(\x01\x12\x36\n\x05state\x18\x02 \x01(\x0b\x32\'.quadrotorilqr_tpu.proto.QuadrotorState\x12.\n\x07\x63ontrol\x18\x03 \x01(\x0b\x32\x1d.quadrotorilqr_tpu.proto.Vec4\"X\n\x13QuadrotorTrajectory\x12\x41\n\x06points\x18\x01 \x03(\x0b\x32\x31.quadrotorilqr_tpu.proto.QuadrotorTrajectoryPointb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'trajectory_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _VEC3._serialized_start=45
  _VEC3._serialized_end=87
  _VEC4._serialized_start=89
  _VEC4._serialized_end=143
  _VEC6._serialized_start=145
  _VEC6._serialized_end=223
  _SO3._serialized_start=225
  _SO3._serialized_end=281
  _SE3._serialized_start=283
  _SE3._serialized_end=388
  _QUADROTORSTATE._serialized_start=391
  _QUADROTORSTATE._serialized_end=519
  _QUADROTORTRAJECTORYPOINT._serialized_start=522
  _QUADROTORTRAJECTORYPOINT._serialized_end=668
  _QUADROTORTRAJECTORY._serialized_start=670
  _QUADROTORTRAJECTORY._serialized_end=758
# @@protoc_insertion_point(module_scope)
