# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/trace/v1/query.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import trace_pb2 as banyandb_dot_common_dot_v1_dot_trace__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import query_pb2 as banyandb_dot_model_dot_v1_dot_query__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import write_pb2 as banyandb_dot_model_dot_v1_dot_write__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1d\x62\x61nyandb/trace/v1/query.proto\x12\x11\x62\x61nyandb.trace.v1\x1a\x1e\x62\x61nyandb/common/v1/trace.proto\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a\x1d\x62\x61nyandb/model/v1/write.proto\"K\n\x04Span\x12$\n\x04tags\x18\x01 \x03(\x0b\x32\x16.banyandb.model.v1.Tag\x12\x0c\n\x04span\x18\x02 \x01(\x0c\x12\x0f\n\x07span_id\x18\x03 \x01(\t\"V\n\rInternalTrace\x12&\n\x05spans\x18\x01 \x03(\x0b\x32\x17.banyandb.trace.v1.Span\x12\x10\n\x08trace_id\x18\x02 \x01(\t\x12\x0b\n\x03key\x18\x03 \x01(\x03\"A\n\x05Trace\x12&\n\x05spans\x18\x01 \x03(\x0b\x32\x17.banyandb.trace.v1.Span\x12\x10\n\x08trace_id\x18\x02 \x01(\t\"\x8e\x02\n\rQueryResponse\x12(\n\x06traces\x18\x01 \x03(\x0b\x32\x18.banyandb.trace.v1.Trace\x12\x35\n\x12trace_query_result\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\x12K\n\x0egroup_statuses\x18\x32 \x03(\x0b\x32\x33.banyandb.trace.v1.QueryResponse.GroupStatusesEntry\x1aO\n\x12GroupStatusesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0e\x32\x19.banyandb.model.v1.Status:\x02\x38\x01\"\x89\x01\n\x15InternalQueryResponse\x12\x39\n\x0finternal_traces\x18\x01 \x03(\x0b\x32 .banyandb.trace.v1.InternalTrace\x12\x35\n\x12trace_query_result\x18\x02 \x01(\x0b\x32\x19.banyandb.common.v1.Trace\"\xa3\x03\n\x0cQueryRequest\x12\x0e\n\x06groups\x18\x01 \x03(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x30\n\ntime_range\x18\x03 \x01(\x0b\x32\x1c.banyandb.model.v1.TimeRange\x12\x0e\n\x06offset\x18\x04 \x01(\r\x12\r\n\x05limit\x18\x05 \x01(\r\x12/\n\x08order_by\x18\x06 \x01(\x0b\x32\x1d.banyandb.model.v1.QueryOrder\x12-\n\x08\x63riteria\x18\x07 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\x12\x16\n\x0etag_projection\x18\x08 \x03(\t\x12\r\n\x05trace\x18\t \x01(\x08\x12\x0e\n\x06stages\x18\n \x03(\t\x12S\n\x13group_mod_revisions\x18\x32 \x03(\x0b\x32\x36.banyandb.trace.v1.QueryRequest.GroupModRevisionsEntry\x1a\x38\n\x16GroupModRevisionsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x03:\x02\x38\x01\x42l\n\'org.apache.skywalking.banyandb.trace.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/trace/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.trace.v1.query_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n\'org.apache.skywalking.banyandb.trace.v1ZAgithub.com/apache/skywalking-banyandb/api/proto/banyandb/trace/v1'
  _QUERYRESPONSE_GROUPSTATUSESENTRY._options = None
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_options = b'8\001'
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._options = None
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_options = b'8\001'
  _SPAN._serialized_start=146
  _SPAN._serialized_end=221
  _INTERNALTRACE._serialized_start=223
  _INTERNALTRACE._serialized_end=309
  _TRACE._serialized_start=311
  _TRACE._serialized_end=376
  _QUERYRESPONSE._serialized_start=379
  _QUERYRESPONSE._serialized_end=649
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_start=570
  _QUERYRESPONSE_GROUPSTATUSESENTRY._serialized_end=649
  _INTERNALQUERYRESPONSE._serialized_start=652
  _INTERNALQUERYRESPONSE._serialized_end=789
  _QUERYREQUEST._serialized_start=792
  _QUERYREQUEST._serialized_end=1211
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_start=1155
  _QUERYREQUEST_GROUPMODREVISIONSENTRY._serialized_end=1211
# @@protoc_insertion_point(module_scope)
