# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/common/v1/trace.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1e\x62\x61nyandb/common/v1/trace.proto\x12\x12\x62\x61nyandb.common.v1\x1a\x1fgoogle/protobuf/timestamp.proto\"Q\n\x05Trace\x12\x10\n\x08trace_id\x18\x01 \x01(\t\x12\'\n\x05spans\x18\x02 \x03(\x0b\x32\x18.banyandb.common.v1.Span\x12\r\n\x05\x65rror\x18\x03 \x01(\x08\"\xe9\x01\n\x04Span\x12.\n\nstart_time\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12,\n\x08\x65nd_time\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\r\n\x05\x65rror\x18\x03 \x01(\x08\x12%\n\x04tags\x18\x04 \x03(\x0b\x32\x17.banyandb.common.v1.Tag\x12\x0f\n\x07message\x18\x05 \x01(\t\x12*\n\x08\x63hildren\x18\x06 \x03(\x0b\x32\x18.banyandb.common.v1.Span\x12\x10\n\x08\x64uration\x18\x07 \x01(\x03\"!\n\x03Tag\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\tBn\n(org.apache.skywalking.banyandb.common.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/common/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.common.v1.trace_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.common.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/common/v1'
  _TRACE._serialized_start=87
  _TRACE._serialized_end=168
  _SPAN._serialized_start=171
  _SPAN._serialized_end=404
  _TAG._serialized_start=406
  _TAG._serialized_end=439
# @@protoc_insertion_point(module_scope)
