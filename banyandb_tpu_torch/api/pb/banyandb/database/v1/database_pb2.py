# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/database/v1/database.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#banyandb/database/v1/database.proto\x12\x14\x62\x61nyandb.database.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"\xa4\x03\n\x04Node\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12)\n\x05roles\x18\x02 \x03(\x0e\x32\x1a.banyandb.database.v1.Role\x12\x14\n\x0cgrpc_address\x18\x03 \x01(\t\x12\x14\n\x0chttp_address\x18\x04 \x01(\t\x12.\n\ncreated_at\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x36\n\x06labels\x18\x06 \x03(\x0b\x32&.banyandb.database.v1.Node.LabelsEntry\x12+\n#property_repair_gossip_grpc_address\x18\x07 \x01(\t\x12$\n\x1cproperty_schema_grpc_address\x18\x08 \x01(\t\x12+\n#property_schema_gossip_grpc_address\x18\t \x01(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xee\x01\n\x05Shard\x12\n\n\x02id\x18\x01 \x01(\x04\x12.\n\x08metadata\x18\x02 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12,\n\x07\x63\x61talog\x18\x03 \x01(\x0e\x32\x1b.banyandb.common.v1.Catalog\x12\x0c\n\x04node\x18\x04 \x01(\t\x12\r\n\x05total\x18\x05 \x01(\r\x12.\n\nupdated_at\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\ncreated_at\x18\x07 \x01(\x0b\x32\x1a.google.protobuf.Timestamp*L\n\x04Role\x12\x14\n\x10ROLE_UNSPECIFIED\x10\x00\x12\r\n\tROLE_META\x10\x01\x12\r\n\tROLE_DATA\x10\x02\x12\x10\n\x0cROLE_LIAISON\x10\x03\x42r\n*org.apache.skywalking.banyandb.database.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/database/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.database.v1.database_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n*org.apache.skywalking.banyandb.database.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/database/v1'
  _NODE_LABELSENTRY._options = None
  _NODE_LABELSENTRY._serialized_options = b'8\001'
  _ROLE._serialized_start=791
  _ROLE._serialized_end=867
  _NODE._serialized_start=128
  _NODE._serialized_end=548
  _NODE_LABELSENTRY._serialized_start=503
  _NODE_LABELSENTRY._serialized_end=548
  _SHARD._serialized_start=551
  _SHARD._serialized_end=789
# @@protoc_insertion_point(module_scope)
