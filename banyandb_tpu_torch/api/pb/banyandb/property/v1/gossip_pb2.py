# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/property/v1/gossip.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!banyandb/property/v1/gossip.proto\x12\x14\x62\x61nyandb.property.v1\"z\n\x12PropagationContext\x12\r\n\x05nodes\x18\x01 \x03(\t\x12\x1d\n\x15max_propagation_count\x18\x02 \x01(\x05\x12!\n\x19\x63urrent_propagation_count\x18\x03 \x01(\x05\x12\x13\n\x0borigin_node\x18\x04 \x01(\t\"C\n\x17PropagationTraceContext\x12\x10\n\x08trace_id\x18\x01 \x01(\t\x12\x16\n\x0eparent_span_id\x18\x02 \x01(\t\"\xb6\x01\n\x12PropagationRequest\x12\x39\n\x07\x63ontext\x18\x01 \x01(\x0b\x32(.banyandb.property.v1.PropagationContext\x12\x44\n\rtrace_context\x18\x02 \x01(\x0b\x32-.banyandb.property.v1.PropagationTraceContext\x12\r\n\x05group\x18\x03 \x01(\t\x12\x10\n\x08shard_id\x18\x04 \x01(\r\"\x15\n\x13PropagationResponse2u\n\rGossipService\x12\x64\n\x0bPropagation\x12(.banyandb.property.v1.PropagationRequest\x1a).banyandb.property.v1.PropagationResponse\"\x00\x42r\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.property.v1.gossip_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n*org.apache.skywalking.banyandb.property.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/property/v1'
  _PROPAGATIONCONTEXT._serialized_start=59
  _PROPAGATIONCONTEXT._serialized_end=181
  _PROPAGATIONTRACECONTEXT._serialized_start=183
  _PROPAGATIONTRACECONTEXT._serialized_end=250
  _PROPAGATIONREQUEST._serialized_start=253
  _PROPAGATIONREQUEST._serialized_end=435
  _PROPAGATIONRESPONSE._serialized_start=437
  _PROPAGATIONRESPONSE._serialized_end=458
  _GOSSIPSERVICE._serialized_start=460
  _GOSSIPSERVICE._serialized_end=577
# @@protoc_insertion_point(module_scope)
