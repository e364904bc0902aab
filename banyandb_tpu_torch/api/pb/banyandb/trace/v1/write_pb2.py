# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/trace/v1/write.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1d\x62\x61nyandb/trace/v1/write.proto\x12\x11\x62\x61nyandb.trace.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\"\x1c\n\x07TagSpec\x12\x11\n\ttag_names\x18\x01 \x03(\t\"\xb6\x01\n\x0cWriteRequest\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12)\n\x04tags\x18\x02 \x03(\x0b\x32\x1b.banyandb.model.v1.TagValue\x12\x0c\n\x04span\x18\x03 \x01(\x0c\x12\x0f\n\x07version\x18\x04 \x01(\x04\x12,\n\x08tag_spec\x18\x05 \x01(\x0b\x32\x1a.banyandb.trace.v1.TagSpec\"`\n\rWriteResponse\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x0f\n\x07version\x18\x02 \x01(\x04\x12\x0e\n\x06status\x18\x03 \x01(\t\"Z\n\x14InternalWriteRequest\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x30\n\x07request\x18\x02 \x01(\x0b\x32\x1f.banyandb.trace.v1.WriteRequestBl\n\'org.apache.skywalking.banyandb.trace.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/trace/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.trace.v1.write_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n\'org.apache.skywalking.banyandb.trace.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/trace/v1'
  _TAGSPEC._serialized_start=117
  _TAGSPEC._serialized_end=145
  _WRITEREQUEST._serialized_start=148
  _WRITEREQUEST._serialized_end=330
  _WRITERESPONSE._serialized_start=332
  _WRITERESPONSE._serialized_end=428
  _INTERNALWRITEREQUEST._serialized_start=430
  _INTERNALWRITEREQUEST._serialized_end=520
# @@protoc_insertion_point(module_scope)
