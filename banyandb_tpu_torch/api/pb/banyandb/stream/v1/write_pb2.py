# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/stream/v1/write.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x62\x61nyandb/stream/v1/write.proto\x12\x12\x62\x61nyandb.stream.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"0\n\rTagFamilySpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\ttag_names\x18\x02 \x03(\t\"\x8d\x01\n\x0c\x45lementValue\x12\x12\n\nelement_id\x18\x01 \x01(\t\x12-\n\ttimestamp\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12:\n\x0ctag_families\x18\x03 \x03(\x0b\x32$.banyandb.model.v1.TagFamilyForWrite\"\xc1\x01\n\x0cWriteRequest\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x31\n\x07\x65lement\x18\x02 \x01(\x0b\x32 .banyandb.stream.v1.ElementValue\x12\x12\n\nmessage_id\x18\x03 \x01(\x04\x12:\n\x0ftag_family_spec\x18\x04 \x03(\x0b\x32!.banyandb.stream.v1.TagFamilySpec\"c\n\rWriteResponse\x12\x12\n\nmessage_id\x18\x01 \x01(\x04\x12\x0e\n\x06status\x18\x02 \x01(\t\x12.\n\x08metadata\x18\x03 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\"\xa7\x01\n\x14InternalWriteRequest\x12\x10\n\x08shard_id\x18\x01 \x01(\r\x12\x32\n\rentity_values\x18\x02 \x03(\x0b\x32\x1b.banyandb.model.v1.TagValue\x12\x31\n\x07request\x18\x03 \x01(\x0b\x32 .banyandb.stream.v1.WriteRequest\x12\x16\n\x0eraw_element_id\x18\x04 \x01(\x04\x42n\n(org.apache.skywalking.banyandb.stream.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/stream/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.stream.v1.write_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.stream.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/stream/v1'
  _TAGFAMILYSPEC._serialized_start=152
  _TAGFAMILYSPEC._serialized_end=200
  _ELEMENTVALUE._serialized_start=203
  _ELEMENTVALUE._serialized_end=344
  _WRITEREQUEST._serialized_start=347
  _WRITEREQUEST._serialized_end=540
  _WRITERESPONSE._serialized_start=542
  _WRITERESPONSE._serialized_end=641
  _INTERNALWRITEREQUEST._serialized_start=644
  _INTERNALWRITEREQUEST._serialized_end=811
# @@protoc_insertion_point(module_scope)
