# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: ilqr_options.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12ilqr_options.proto\x12\x17quadrotorilqr_tpu.proto\"Z\n\x10LineSearchParams\x12\x13\n\x0bstep_update\x18\x01 \x01(\x01\x12\x1e\n\x16\x64\x65sired_reduction_frac\x18\x02 \x01(\x01\x12\x11\n\tmax_iters\x18\x03 \x01(\x05\"D\n\x13\x43onvergenceCriteria\x12\x0c\n\x04rtol\x18\x01 \x01(\x01\x12\x0c\n\x04\x61tol\x18\x02 \x01(\x01\x12\x11\n\tmax_iters\x18\x03 \x01(\x01\"\xb8\x01\n\x0bILQROptions\x12\x45\n\x12line_search_params\x18\x01 \x01(\x0b\x32).quadrotorilqr_tpu.proto.LineSearchParams\x12J\n\x14\x63onvergence_criteria\x18\x02 \x01(\x0b\x32,.quadrotorilqr_tpu.proto.ConvergenceCriteria\x12\x16\n\x0epopulate_debug\x18\x03 \x01(\x08\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'ilqr_options_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LINESEARCHPARAMS._serialized_start=47
  _LINESEARCHPARAMS._serialized_end=137
  _CONVERGENCECRITERIA._serialized_start=139
  _CONVERGENCECRITERIA._serialized_end=207
  _ILQROPTIONS._serialized_start=210
  _ILQROPTIONS._serialized_end=394
# @@protoc_insertion_point(module_scope)
