# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/trace/v1/rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.trace.v1 import query_pb2 as banyandb_dot_trace_dot_v1_dot_query__pb2
from banyandb_tpu_torch.api.pb.banyandb.trace.v1 import write_pb2 as banyandb_dot_trace_dot_v1_dot_write__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1b\x62\x61nyandb/trace/v1/rpc.proto\x12\x11\x62\x61nyandb.trace.v1\x1a\x1d\x62\x61nyandb/trace/v1/query.proto\x1a\x1d\x62\x61nyandb/trace/v1/write.proto\"G\n\x1c\x44\x65leteExpiredSegmentsRequest\x12\r\n\x05group\x18\x01 \x01(\t\x12\x18\n\x10segment_suffixes\x18\x02 \x03(\t\"0\n\x1d\x44\x65leteExpiredSegmentsResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x03\x32\xa8\x02\n\x0cTraceService\x12L\n\x05Query\x12\x1f.banyandb.trace.v1.QueryRequest\x1a .banyandb.trace.v1.QueryResponse\"\x00\x12N\n\x05Write\x12\x1f.banyandb.trace.v1.WriteRequest\x1a .banyandb.trace.v1.WriteResponse(\x01\x30\x01\x12z\n\x15\x44\x65leteExpiredSegments\x12/.banyandb.trace.v1.DeleteExpiredSegmentsRequest\x1a\x30.banyandb.trace.v1.DeleteExpiredSegmentsResponseBl\n\'org.apache.skywalking.banyandb.trace.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/trace/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.trace.v1.rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n\'org.apache.skywalking.banyandb.trace.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/trace/v1'
  _DELETEEXPIREDSEGMENTSREQUEST._serialized_start=112
  _DELETEEXPIREDSEGMENTSREQUEST._serialized_end=183
  _DELETEEXPIREDSEGMENTSRESPONSE._serialized_start=185
  _DELETEEXPIREDSEGMENTSRESPONSE._serialized_end=233
  _TRACESERVICE._serialized_start=236
  _TRACESERVICE._serialized_end=532
# @@protoc_insertion_point(module_scope)
