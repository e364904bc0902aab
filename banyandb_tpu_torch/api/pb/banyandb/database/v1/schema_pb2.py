# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/database/v1/schema.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import common_pb2 as banyandb_dot_model_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.model.v1 import query_pb2 as banyandb_dot_model_dot_v1_dot_query__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n!banyandb/database/v1/schema.proto\x12\x14\x62\x61nyandb.database.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a\x1e\x62\x61nyandb/model/v1/common.proto\x1a\x1d\x62\x61nyandb/model/v1/query.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"J\n\rTagFamilySpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12+\n\x04tags\x18\x02 \x03(\x0b\x32\x1d.banyandb.database.v1.TagSpec\"D\n\x07TagSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12+\n\x04type\x18\x02 \x01(\x0e\x32\x1d.banyandb.database.v1.TagType\"\x81\x02\n\x06Stream\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x39\n\x0ctag_families\x18\x02 \x03(\x0b\x32#.banyandb.database.v1.TagFamilySpec\x12,\n\x06\x65ntity\x18\x03 \x01(\x0b\x32\x1c.banyandb.database.v1.Entity\x12.\n\nupdated_at\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\ncreated_at\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"\x1b\n\x06\x45ntity\x12\x11\n\ttag_names\x18\x01 \x03(\t\" \n\x0bShardingKey\x12\x11\n\ttag_names\x18\x01 \x03(\t\"\xd2\x01\n\tFieldSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x33\n\nfield_type\x18\x02 \x01(\x0e\x32\x1f.banyandb.database.v1.FieldType\x12=\n\x0f\x65ncoding_method\x18\x03 \x01(\x0e\x32$.banyandb.database.v1.EncodingMethod\x12\x43\n\x12\x63ompression_method\x18\x04 \x01(\x0e\x32\'.banyandb.database.v1.CompressionMethod\"\x92\x03\n\x07Measure\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x39\n\x0ctag_families\x18\x02 \x03(\x0b\x32#.banyandb.database.v1.TagFamilySpec\x12/\n\x06\x66ields\x18\x03 \x03(\x0b\x32\x1f.banyandb.database.v1.FieldSpec\x12,\n\x06\x65ntity\x18\x04 \x01(\x0b\x32\x1c.banyandb.database.v1.Entity\x12\x10\n\x08interval\x18\x05 \x01(\t\x12.\n\nupdated_at\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x12\n\nindex_mode\x18\x07 \x01(\x08\x12\x37\n\x0csharding_key\x18\x08 \x01(\x0b\x32!.banyandb.database.v1.ShardingKey\x12.\n\ncreated_at\x18\t \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"\x94\x03\n\x0fTopNAggregation\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x34\n\x0esource_measure\x18\x02 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x12\n\nfield_name\x18\x03 \x01(\t\x12\x31\n\x10\x66ield_value_sort\x18\x04 \x01(\x0e\x32\x17.banyandb.model.v1.Sort\x12\x1a\n\x12group_by_tag_names\x18\x05 \x03(\t\x12-\n\x08\x63riteria\x18\x06 \x01(\x0b\x32\x1b.banyandb.model.v1.Criteria\x12\x17\n\x0f\x63ounters_number\x18\x07 \x01(\x05\x12\x10\n\x08lru_size\x18\x08 \x01(\x05\x12.\n\nupdated_at\x18\t \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\ncreated_at\x18\n \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"\xd3\x02\n\tIndexRule\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x0c\n\x04tags\x18\x02 \x03(\t\x12\x32\n\x04type\x18\x03 \x01(\x0e\x32$.banyandb.database.v1.IndexRule.Type\x12.\n\nupdated_at\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x10\n\x08\x61nalyzer\x18\x05 \x01(\t\x12\x0f\n\x07no_sort\x18\x06 \x01(\x08\x12.\n\ncreated_at\x18\x07 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"Q\n\x04Type\x12\x14\n\x10TYPE_UNSPECIFIED\x10\x00\x12\x11\n\rTYPE_INVERTED\x10\x01\x12\x11\n\rTYPE_SKIPPING\x10\x02\x12\r\n\tTYPE_TREE\x10\x03\"E\n\x07Subject\x12,\n\x07\x63\x61talog\x18\x01 \x01(\x0e\x32\x1b.banyandb.common.v1.Catalog\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xbe\x02\n\x10IndexRuleBinding\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\r\n\x05rules\x18\x02 \x03(\t\x12.\n\x07subject\x18\x03 \x01(\x0b\x32\x1d.banyandb.database.v1.Subject\x12,\n\x08\x62\x65gin_at\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12-\n\texpire_at\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\nupdated_at\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\ncreated_at\x18\x07 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"\xc7\x01\n\x08Property\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12+\n\x04tags\x18\x02 \x03(\x0b\x32\x1d.banyandb.database.v1.TagSpec\x12.\n\nupdated_at\x18\x06 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\ncreated_at\x18\x07 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"I\n\x0cTraceTagSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12+\n\x04type\x18\x02 \x01(\x0e\x32\x1d.banyandb.database.v1.TagType\"\x9a\x02\n\x05Trace\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12\x30\n\x04tags\x18\x02 \x03(\x0b\x32\".banyandb.database.v1.TraceTagSpec\x12\x19\n\x11trace_id_tag_name\x18\x03 \x01(\t\x12\x1a\n\x12timestamp_tag_name\x18\x04 \x01(\t\x12.\n\nupdated_at\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x18\n\x10span_id_tag_name\x18\x06 \x01(\t\x12.\n\ncreated_at\x18\x07 \x01(\x0b\x32\x1a.google.protobuf.Timestamp*\xaf\x01\n\x07TagType\x12\x18\n\x14TAG_TYPE_UNSPECIFIED\x10\x00\x12\x13\n\x0fTAG_TYPE_STRING\x10\x01\x12\x10\n\x0cTAG_TYPE_INT\x10\x02\x12\x19\n\x15TAG_TYPE_STRING_ARRAY\x10\x03\x12\x16\n\x12TAG_TYPE_INT_ARRAY\x10\x04\x12\x18\n\x14TAG_TYPE_DATA_BINARY\x10\x05\x12\x16\n\x12TAG_TYPE_TIMESTAMP\x10\x06*\x84\x01\n\tFieldType\x12\x1a\n\x16\x46IELD_TYPE_UNSPECIFIED\x10\x00\x12\x15\n\x11\x46IELD_TYPE_STRING\x10\x01\x12\x12\n\x0e\x46IELD_TYPE_INT\x10\x02\x12\x1a\n\x16\x46IELD_TYPE_DATA_BINARY\x10\x03\x12\x14\n\x10\x46IELD_TYPE_FLOAT\x10\x04*N\n\x0e\x45ncodingMethod\x12\x1f\n\x1b\x45NCODING_METHOD_UNSPECIFIED\x10\x00\x12\x1b\n\x17\x45NCODING_METHOD_GORILLA\x10\x01*T\n\x11\x43ompressionMethod\x12\"\n\x1e\x43OMPRESSION_METHOD_UNSPECIFIED\x10\x00\x12\x1b\n\x17\x43OMPRESSION_METHOD_ZSTD\x10\x01\x42r\n*org.apache.skywalking.banyandb.database.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/database/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.database.v1.schema_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n*org.apache.skywalking.banyandb.database.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/database/v1'
  _TAGTYPE._serialized_start=2979
  _TAGTYPE._serialized_end=3154
  _FIELDTYPE._serialized_start=3157
  _FIELDTYPE._serialized_end=3289
  _ENCODINGMETHOD._serialized_start=3291
  _ENCODINGMETHOD._serialized_end=3369
  _COMPRESSIONMETHOD._serialized_start=3371
  _COMPRESSIONMETHOD._serialized_end=3455
  _TAGFAMILYSPEC._serialized_start=188
  _TAGFAMILYSPEC._serialized_end=262
  _TAGSPEC._serialized_start=264
  _TAGSPEC._serialized_end=332
  _STREAM._serialized_start=335
  _STREAM._serialized_end=592
  _ENTITY._serialized_start=594
  _ENTITY._serialized_end=621
  _SHARDINGKEY._serialized_start=623
  _SHARDINGKEY._serialized_end=655
  _FIELDSPEC._serialized_start=658
  _FIELDSPEC._serialized_end=868
  _MEASURE._serialized_start=871
  _MEASURE._serialized_end=1273
  _TOPNAGGREGATION._serialized_start=1276
  _TOPNAGGREGATION._serialized_end=1680
  _INDEXRULE._serialized_start=1683
  _INDEXRULE._serialized_end=2022
  _INDEXRULE_TYPE._serialized_start=1941
  _INDEXRULE_TYPE._serialized_end=2022
  _SUBJECT._serialized_start=2024
  _SUBJECT._serialized_end=2093
  _INDEXRULEBINDING._serialized_start=2096
  _INDEXRULEBINDING._serialized_end=2414
  _PROPERTY._serialized_start=2417
  _PROPERTY._serialized_end=2616
  _TRACETAGSPEC._serialized_start=2618
  _TRACETAGSPEC._serialized_end=2691
  _TRACE._serialized_start=2694
  _TRACE._serialized_end=2976
# @@protoc_insertion_point(module_scope)
