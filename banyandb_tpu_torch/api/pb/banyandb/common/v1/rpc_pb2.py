# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/common/v1/rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1c\x62\x61nyandb/common/v1/rpc.proto\x12\x12\x62\x61nyandb.common.v1\"/\n\nAPIVersion\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x10\n\x08revision\x18\x02 \x01(\t\"\x16\n\x14GetAPIVersionRequest\"H\n\x15GetAPIVersionResponse\x12/\n\x07version\x18\x01 \x01(\x0b\x32\x1e.banyandb.common.v1.APIVersion2q\n\x07Service\x12\x66\n\rGetAPIVersion\x12(.banyandb.common.v1.GetAPIVersionRequest\x1a).banyandb.common.v1.GetAPIVersionResponse\"\x00\x42n\n(org.apache.skywalking.banyandb.common.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/common/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.common.v1.rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.common.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/common/v1'
  _APIVERSION._serialized_start=52
  _APIVERSION._serialized_end=99
  _GETAPIVERSIONREQUEST._serialized_start=101
  _GETAPIVERSIONREQUEST._serialized_end=123
  _GETAPIVERSIONRESPONSE._serialized_start=125
  _GETAPIVERSIONRESPONSE._serialized_end=197
  _SERVICE._serialized_start=199
  _SERVICE._serialized_end=312
# @@protoc_insertion_point(module_scope)
