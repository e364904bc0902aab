# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/common/v1/common.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from google.protobuf import duration_pb2 as google_dot_protobuf_dot_duration__pb2
from google.protobuf import struct_pb2 as google_dot_protobuf_dot_struct__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1f\x62\x61nyandb/common/v1/common.proto\x12\x12\x62\x61nyandb.common.v1\x1a\x1egoogle/protobuf/duration.proto\x1a\x1cgoogle/protobuf/struct.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"b\n\x08Metadata\x12\r\n\x05group\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\n\n\x02id\x18\x03 \x01(\r\x12\x17\n\x0f\x63reate_revision\x18\x04 \x01(\x03\x12\x14\n\x0cmod_revision\x18\x05 \x01(\x03\"\x8b\x01\n\x0cIntervalRule\x12\x33\n\x04unit\x18\x01 \x01(\x0e\x32%.banyandb.common.v1.IntervalRule.Unit\x12\x0b\n\x03num\x18\x02 \x01(\r\"9\n\x04Unit\x12\x14\n\x10UNIT_UNSPECIFIED\x10\x00\x12\r\n\tUNIT_HOUR\x10\x01\x12\x0c\n\x08UNIT_DAY\x10\x02\"\xd4\x01\n\x0eLifecycleStage\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tshard_num\x18\x02 \x01(\r\x12:\n\x10segment_interval\x18\x03 \x01(\x0b\x32 .banyandb.common.v1.IntervalRule\x12-\n\x03ttl\x18\x04 \x01(\x0b\x32 .banyandb.common.v1.IntervalRule\x12\x15\n\rnode_selector\x18\x05 \x01(\t\x12\r\n\x05\x63lose\x18\x06 \x01(\x08\x12\x10\n\x08replicas\x18\x07 \x01(\r\"\xea\x01\n\x0cResourceOpts\x12\x11\n\tshard_num\x18\x01 \x01(\r\x12:\n\x10segment_interval\x18\x02 \x01(\x0b\x32 .banyandb.common.v1.IntervalRule\x12-\n\x03ttl\x18\x03 \x01(\x0b\x32 .banyandb.common.v1.IntervalRule\x12\x32\n\x06stages\x18\x04 \x03(\x0b\x32\".banyandb.common.v1.LifecycleStage\x12\x16\n\x0e\x64\x65\x66\x61ult_stages\x18\x05 \x03(\t\x12\x10\n\x08replicas\x18\x06 \x01(\r\"k\n\rSamplerPlugin\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0e\n\x06symbol\x18\x02 \x01(\t\x12\x13\n\x0b\x61\x62i_version\x18\x03 \x01(\r\x12\'\n\x06\x63onfig\x18\x04 \x01(\x0b\x32\x17.google.protobuf.Struct\"T\n\x06Plugin\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x34\n\x07sampler\x18\x02 \x01(\x0b\x32!.banyandb.common.v1.SamplerPluginH\x00\x42\x06\n\x04kind\"G\n\tStageRule\x12\r\n\x05stage\x18\x01 \x01(\t\x12+\n\x07plugins\x18\x02 \x03(\x0b\x32\x1a.banyandb.common.v1.Plugin\"\xd1\x02\n\x13TracePipelineConfig\x12\x0f\n\x07\x65nabled\x18\x01 \x01(\x08\x12+\n\x07plugins\x18\x02 \x03(\x0b\x32\x1a.banyandb.common.v1.Plugin\x12.\n\x0bmerge_grace\x18\x03 \x01(\x0b\x32\x19.google.protobuf.Duration\x12\x31\n\x0e\x66inalize_grace\x18\x04 \x01(\x0b\x32\x19.google.protobuf.Duration\x12-\n\x06stages\x18\x05 \x03(\x0b\x32\x1d.banyandb.common.v1.StageRule\x12\x14\n\x0cschema_names\x18\x06 \x03(\t\x12\x19\n\x11schema_name_regex\x18\x07 \x01(\t\x12\x39\n\x0e\x65nabled_events\x18\x08 \x03(\x0e\x32!.banyandb.common.v1.PipelineEvent\"\xcb\x02\n\x05Group\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\x12,\n\x07\x63\x61talog\x18\x02 \x01(\x0e\x32\x1b.banyandb.common.v1.Catalog\x12\x37\n\rresource_opts\x18\x03 \x01(\x0b\x32 .banyandb.common.v1.ResourceOpts\x12.\n\nupdated_at\x18\x04 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12.\n\ncreated_at\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12>\n\x08pipeline\x18\x06 \x01(\x0b\x32\'.banyandb.common.v1.TracePipelineConfigH\x00\x88\x01\x01\x42\x0b\n\t_pipeline*t\n\x07\x43\x61talog\x12\x17\n\x13\x43\x41TALOG_UNSPECIFIED\x10\x00\x12\x12\n\x0e\x43\x41TALOG_STREAM\x10\x01\x12\x13\n\x0f\x43\x41TALOG_MEASURE\x10\x02\x12\x14\n\x10\x43\x41TALOG_PROPERTY\x10\x03\x12\x11\n\rCATALOG_TRACE\x10\x04*f\n\rPipelineEvent\x12\x1e\n\x1aPIPELINE_EVENT_UNSPECIFIED\x10\x00\x12\x18\n\x14PIPELINE_EVENT_MERGE\x10\x01\x12\x1b\n\x17PIPELINE_EVENT_FINALIZE\x10\x02\x42n\n(org.apache.skywalking.banyandb.common.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/common/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.common.v1.common_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n(org.apache.skywalking.banyandb.common.v1ZBgithub.com/apache/skywalking-banyandb/api/proto/banyandb/common/v1'
  _CATALOG._serialized_start=1786
  _CATALOG._serialized_end=1902
  _PIPELINEEVENT._serialized_start=1904
  _PIPELINEEVENT._serialized_end=2006
  _METADATA._serialized_start=150
  _METADATA._serialized_end=248
  _INTERVALRULE._serialized_start=251
  _INTERVALRULE._serialized_end=390
  _INTERVALRULE_UNIT._serialized_start=333
  _INTERVALRULE_UNIT._serialized_end=390
  _LIFECYCLESTAGE._serialized_start=393
  _LIFECYCLESTAGE._serialized_end=605
  _RESOURCEOPTS._serialized_start=608
  _RESOURCEOPTS._serialized_end=842
  _SAMPLERPLUGIN._serialized_start=844
  _SAMPLERPLUGIN._serialized_end=951
  _PLUGIN._serialized_start=953
  _PLUGIN._serialized_end=1037
  _STAGERULE._serialized_start=1039
  _STAGERULE._serialized_end=1110
  _TRACEPIPELINECONFIG._serialized_start=1113
  _TRACEPIPELINECONFIG._serialized_end=1450
  _GROUP._serialized_start=1453
  _GROUP._serialized_end=1784
# @@protoc_insertion_point(module_scope)
