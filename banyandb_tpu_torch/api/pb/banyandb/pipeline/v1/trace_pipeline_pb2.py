# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/pipeline/v1/trace_pipeline.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n)banyandb/pipeline/v1/trace_pipeline.proto\x12\x14\x62\x61nyandb.pipeline.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\"s\n)TracePipelineRegistryServiceCreateRequest\x12\x46\n\x15trace_pipeline_config\x18\x01 \x01(\x0b\x32\'.banyandb.common.v1.TracePipelineConfig\"B\n*TracePipelineRegistryServiceCreateResponse\x12\x14\n\x0cmod_revision\x18\x01 \x01(\x03\"s\n)TracePipelineRegistryServiceUpdateRequest\x12\x46\n\x15trace_pipeline_config\x18\x01 \x01(\x0b\x32\'.banyandb.common.v1.TracePipelineConfig\"B\n*TracePipelineRegistryServiceUpdateResponse\x12\x14\n\x0cmod_revision\x18\x01 \x01(\x03\"[\n)TracePipelineRegistryServiceDeleteRequest\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\"h\n*TracePipelineRegistryServiceDeleteResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x08\x12\x13\n\x0b\x64\x65lete_time\x18\x02 \x01(\x03\x12\x14\n\x0cmod_revision\x18\x03 \x01(\x03\"X\n&TracePipelineRegistryServiceGetRequest\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\"q\n\'TracePipelineRegistryServiceGetResponse\x12\x46\n\x15trace_pipeline_config\x18\x01 \x01(\x0b\x32\'.banyandb.common.v1.TracePipelineConfig\"Z\n(TracePipelineRegistryServiceExistRequest\x12.\n\x08metadata\x18\x01 \x01(\x0b\x32\x1c.banyandb.common.v1.Metadata\"a\n)TracePipelineRegistryServiceExistResponse\x12\x11\n\thas_group\x18\x01 \x01(\x08\x12!\n\x19has_trace_pipeline_config\x18\x02 \x01(\x08\"8\n\'TracePipelineRegistryServiceListRequest\x12\r\n\x05group\x18\x01 \x01(\t\"r\n(TracePipelineRegistryServiceListResponse\x12\x46\n\x15trace_pipeline_config\x18\x01 \x03(\x0b\x32\'.banyandb.common.v1.TracePipelineConfig2\xea\x06\n\x1cTracePipelineRegistryService\x12\x8d\x01\n\x06\x43reate\x12?.banyandb.pipeline.v1.TracePipelineRegistryServiceCreateRequest\x1a@.banyandb.pipeline.v1.TracePipelineRegistryServiceCreateResponse\"\x00\x12\x8d\x01\n\x06Update\x12?.banyandb.pipeline.v1.TracePipelineRegistryServiceUpdateRequest\x1a@.banyandb.pipeline.v1.TracePipelineRegistryServiceUpdateResponse\"\x00\x12\x8d\x01\n\x06\x44\x65lete\x12?.banyandb.pipeline.v1.TracePipelineRegistryServiceDeleteRequest\x1a@.banyandb.pipeline.v1.TracePipelineRegistryServiceDeleteResponse\"\x00\x12\x84\x01\n\x03Get\x12<.banyandb.pipeline.v1.TracePipelineRegistryServiceGetRequest\x1a=.banyandb.pipeline.v1.TracePipelineRegistryServiceGetResponse\"\x00\x12\x87\x01\n\x04List\x12=.banyandb.pipeline.v1.TracePipelineRegistryServiceListRequest\x1a>.banyandb.pipeline.v1.TracePipelineRegistryServiceListResponse\"\x00\x12\x88\x01\n\x05\x45xist\x12>.banyandb.pipeline.v1.TracePipelineRegistryServiceExistRequest\x1a?.banyandb.pipeline.v1.TracePipelineRegistryServiceExistResponseBr\n*org.apache.skywalking.banyandb.pipeline.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/pipeline/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.pipeline.v1.trace_pipeline_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'\n*org.apache.skywalking.banyandb.pipeline.v1ZDgithub.com/apache/skywalking-banyandb/api/proto/banyandb/pipeline/v1'
  _TRACEPIPELINEREGISTRYSERVICECREATEREQUEST._serialized_start=100
  _TRACEPIPELINEREGISTRYSERVICECREATEREQUEST._serialized_end=215
  _TRACEPIPELINEREGISTRYSERVICECREATERESPONSE._serialized_start=217
  _TRACEPIPELINEREGISTRYSERVICECREATERESPONSE._serialized_end=283
  _TRACEPIPELINEREGISTRYSERVICEUPDATEREQUEST._serialized_start=285
  _TRACEPIPELINEREGISTRYSERVICEUPDATEREQUEST._serialized_end=400
  _TRACEPIPELINEREGISTRYSERVICEUPDATERESPONSE._serialized_start=402
  _TRACEPIPELINEREGISTRYSERVICEUPDATERESPONSE._serialized_end=468
  _TRACEPIPELINEREGISTRYSERVICEDELETEREQUEST._serialized_start=470
  _TRACEPIPELINEREGISTRYSERVICEDELETEREQUEST._serialized_end=561
  _TRACEPIPELINEREGISTRYSERVICEDELETERESPONSE._serialized_start=563
  _TRACEPIPELINEREGISTRYSERVICEDELETERESPONSE._serialized_end=667
  _TRACEPIPELINEREGISTRYSERVICEGETREQUEST._serialized_start=669
  _TRACEPIPELINEREGISTRYSERVICEGETREQUEST._serialized_end=757
  _TRACEPIPELINEREGISTRYSERVICEGETRESPONSE._serialized_start=759
  _TRACEPIPELINEREGISTRYSERVICEGETRESPONSE._serialized_end=872
  _TRACEPIPELINEREGISTRYSERVICEEXISTREQUEST._serialized_start=874
  _TRACEPIPELINEREGISTRYSERVICEEXISTREQUEST._serialized_end=964
  _TRACEPIPELINEREGISTRYSERVICEEXISTRESPONSE._serialized_start=966
  _TRACEPIPELINEREGISTRYSERVICEEXISTRESPONSE._serialized_end=1063
  _TRACEPIPELINEREGISTRYSERVICELISTREQUEST._serialized_start=1065
  _TRACEPIPELINEREGISTRYSERVICELISTREQUEST._serialized_end=1121
  _TRACEPIPELINEREGISTRYSERVICELISTRESPONSE._serialized_start=1123
  _TRACEPIPELINEREGISTRYSERVICELISTRESPONSE._serialized_end=1237
  _TRACEPIPELINEREGISTRYSERVICE._serialized_start=1240
  _TRACEPIPELINEREGISTRYSERVICE._serialized_end=2114
# @@protoc_insertion_point(module_scope)
