# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: banyandb/fodc/v1/rpc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()


from banyandb_tpu_torch.api.pb.banyandb.common.v1 import common_pb2 as banyandb_dot_common_dot_v1_dot_common__pb2
from banyandb_tpu_torch.api.pb.banyandb.database.v1 import database_pb2 as banyandb_dot_database_dot_v1_dot_database__pb2
from banyandb_tpu_torch.api.pb.banyandb.database.v1 import rpc_pb2 as banyandb_dot_database_dot_v1_dot_rpc__pb2
from google.protobuf import timestamp_pb2 as google_dot_protobuf_dot_timestamp__pb2


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x1a\x62\x61nyandb/fodc/v1/rpc.proto\x12\x10\x62\x61nyandb.fodc.v1\x1a\x1f\x62\x61nyandb/common/v1/common.proto\x1a#banyandb/database/v1/database.proto\x1a\x1e\x62\x61nyandb/database/v1/rpc.proto\x1a\x1fgoogle/protobuf/timestamp.proto\"\xc7\x01\n\x14RegisterAgentRequest\x12\x11\n\tnode_role\x18\x01 \x01(\t\x12\x42\n\x06labels\x18\x02 \x03(\x0b\x32\x32.banyandb.fodc.v1.RegisterAgentRequest.LabelsEntry\x12\x10\n\x08pod_name\x18\x04 \x01(\t\x12\x17\n\x0f\x63ontainer_names\x18\x05 \x03(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"o\n\x15RegisterAgentResponse\x12\x0f\n\x07success\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\x12\"\n\x1aheartbeat_interval_seconds\x18\x03 \x01(\x03\x12\x10\n\x08\x61gent_id\x18\x04 \x01(\t\"p\n\x14StreamMetricsRequest\x12)\n\x07metrics\x18\x01 \x03(\x0b\x32\x18.banyandb.fodc.v1.Metric\x12-\n\ttimestamp\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"\xfa\x01\n\x06Metric\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x34\n\x06labels\x18\x02 \x03(\x0b\x32$.banyandb.fodc.v1.Metric.LabelsEntry\x12\r\n\x05value\x18\x03 \x01(\x01\x12\x13\n\x0b\x64\x65scription\x18\x04 \x01(\t\x12-\n\ttimestamp\x18\x05 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12*\n\x04type\x18\x06 \x01(\x0e\x32\x1c.banyandb.fodc.v1.MetricType\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"u\n\x15StreamMetricsResponse\x12.\n\nstart_time\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12,\n\x08\x65nd_time\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\"2\n\x04\x43\x61ll\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06target\x18\x02 \x01(\t\x12\x0e\n\x06source\x18\x03 \x01(\t\"\\\n\x08Topology\x12)\n\x05nodes\x18\x01 \x03(\x0b\x32\x1a.banyandb.database.v1.Node\x12%\n\x05\x63\x61lls\x18\x02 \x03(\x0b\x32\x16.banyandb.fodc.v1.Call\"{\n\x1cStreamClusterTopologyRequest\x12-\n\ttimestamp\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12,\n\x08topology\x18\x02 \x01(\x0b\x32\x1a.banyandb.fodc.v1.Topology\"9\n\x1dStreamClusterTopologyResponse\x12\x18\n\x10request_topology\x18\x01 \x01(\x08\"\x92\x01\n\x16StreamLifecycleRequest\x12-\n\ttimestamp\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x10\n\x08pod_name\x18\x02 \x01(\t\x12\x37\n\x0elifecycle_data\x18\x03 \x01(\x0b\x32\x1f.banyandb.fodc.v1.LifecycleData\"4\n\x17StreamLifecycleResponse\x12\x19\n\x11request_lifecycle\x18\x01 \x01(\x08\"y\n\rLifecycleData\x12\x32\n\x07reports\x18\x01 \x03(\x0b\x32!.banyandb.fodc.v1.LifecycleReport\x12\x34\n\x06groups\x18\x02 \x03(\x0b\x32$.banyandb.fodc.v1.GroupLifecycleInfo\"\xaf\x01\n\x12GroupLifecycleInfo\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07\x63\x61talog\x18\x02 \x01(\t\x12\x37\n\rresource_opts\x18\x03 \x01(\x0b\x32 .banyandb.common.v1.ResourceOpts\x12\x31\n\tdata_info\x18\x04 \x03(\x0b\x32\x1e.banyandb.database.v1.DataInfo\x12\x0e\n\x06\x65rrors\x18\x05 \x03(\t\"8\n\x0fLifecycleReport\x12\x10\n\x08\x66ilename\x18\x01 \x01(\t\x12\x13\n\x0breport_json\x18\x02 \x01(\t\"\xcb\x01\n\x0f\x43rashBreadcrumb\x12(\n\x04time\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\r\n\x05stage\x18\x02 \x01(\t\x12\x11\n\tcomponent\x18\x03 \x01(\t\x12=\n\x06\x66ields\x18\x04 \x03(\x0b\x32-.banyandb.fodc.v1.CrashBreadcrumb.FieldsEntry\x1a-\n\x0b\x46ieldsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xda\x02\n\x10\x43rashPanicRecord\x12/\n\x0boccurred_at\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x11\n\tcomponent\x18\x02 \x01(\t\x12\x13\n\x0bpanic_value\x18\x03 \x01(\t\x12\x11\n\trecovered\x18\x04 \x01(\x08\x12\x17\n\x0fgoroutine_stack\x18\x05 \x01(\t\x12\x36\n\x0b\x62readcrumbs\x18\x06 \x03(\x0b\x32!.banyandb.fodc.v1.CrashBreadcrumb\x12Q\n\x10process_metadata\x18\x07 \x03(\x0b\x32\x37.banyandb.fodc.v1.CrashPanicRecord.ProcessMetadataEntry\x1a\x36\n\x14ProcessMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xc7\x01\n\x1dStreamCrashDiagnosticsRequest\x12.\n\nfetched_at\x18\x01 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x17\n\x0fsource_endpoint\x18\x02 \x01(\t\x12\x14\n\x0c\x61rtifact_dir\x18\x03 \x01(\t\x12\x38\n\x0cpanic_record\x18\x04 \x01(\x0b\x32\".banyandb.fodc.v1.CrashPanicRecord\x12\r\n\x05\x66iles\x18\x05 \x03(\t\"=\n\x1eStreamCrashDiagnosticsResponse\x12\x1b\n\x13request_diagnostics\x18\x01 \x01(\x08\"k\n\x13PressureProfileInfo\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x10\n\x08\x66ilename\x18\x02 \x01(\t\x12\x10\n\x08\x66ilepath\x18\x03 \x01(\t\x12\x0e\n\x06\x66ormat\x18\x04 \x01(\t\x12\x12\n\nsize_bytes\x18\x05 \x01(\x03\"\x8f\x02\n\x15PressureProfileRecord\x12\x12\n\nprofile_id\x18\x01 \x01(\t\x12/\n\x0b\x63\x61ptured_at\x18\x02 \x01(\x0b\x32\x1a.google.protobuf.Timestamp\x12\x17\n\x0fsource_endpoint\x18\x03 \x01(\t\x12\x11\n\trss_bytes\x18\x04 \x01(\x04\x12\x1a\n\x12\x63group_limit_bytes\x18\x05 \x01(\x04\x12\x17\n\x0ftrigger_percent\x18\x06 \x01(\r\x12\x17\n\x0fthreshold_bytes\x18\x07 \x01(\x04\x12\x37\n\x08profiles\x18\x08 \x03(\x0b\x32%.banyandb.fodc.v1.PressureProfileInfo\"w\n\x14PressureProfileChunk\x12\x12\n\nrequest_id\x18\x01 \x01(\t\x12\x12\n\nprofile_id\x18\x02 \x01(\t\x12\x0c\n\x04type\x18\x03 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x04 \x01(\x0c\x12\x0c\n\x04last\x18\x05 \x01(\x08\x12\r\n\x05\x65rror\x18\x06 \x01(\t\"\xd7\x01\n\x1dStreamPressureProfilesRequest\x12\x39\n\x06record\x18\x01 \x01(\x0b\x32\'.banyandb.fodc.v1.PressureProfileRecordH\x00\x12\x37\n\rlist_complete\x18\x02 \x01(\x0b\x32\x1e.banyandb.fodc.v1.ListCompleteH\x00\x12\x37\n\x05\x63hunk\x18\x03 \x01(\x0b\x32&.banyandb.fodc.v1.PressureProfileChunkH\x00\x42\t\n\x07payload\"\"\n\x0cListComplete\x12\x12\n\nrequest_id\x18\x01 \x01(\t\"^\n\x14\x46\x65tchPressureProfile\x12\x12\n\nrequest_id\x18\x01 \x01(\t\x12\x12\n\nprofile_id\x18\x02 \x01(\t\x12\x0c\n\x04type\x18\x03 \x01(\t\x12\x10\n\x08\x66ilepath\x18\x04 \x01(\t\"\xa5\x01\n\x1eStreamPressureProfilesResponse\x12\x37\n\rlist_profiles\x18\x01 \x01(\x0b\x32\x1e.banyandb.fodc.v1.ListProfilesH\x00\x12?\n\rfetch_profile\x18\x02 \x01(\x0b\x32&.banyandb.fodc.v1.FetchPressureProfileH\x00\x42\t\n\x07\x63ommand\"\"\n\x0cListProfiles\x12\x12\n\nrequest_id\x18\x01 \x01(\t\"\x13\n\x11InspectAllRequest\"J\n\x12InspectAllResponse\x12\x34\n\x06groups\x18\x01 \x03(\x0b\x32$.banyandb.fodc.v1.GroupLifecycleInfo*\xa6\x01\n\nMetricType\x12\x1b\n\x17METRIC_TYPE_UNSPECIFIED\x10\x00\x12\x15\n\x11METRIC_TYPE_GAUGE\x10\x01\x12\x17\n\x13METRIC_TYPE_COUNTER\x10\x02\x12\x19\n\x15METRIC_TYPE_HISTOGRAM\x10\x03\x12\x17\n\x13METRIC_TYPE_SUMMARY\x10\x04\x12\x17\n\x13METRIC_TYPE_UNTYPED\x10\x05\x32\xc5\x05\n\x0b\x46ODCService\x12\x64\n\rRegisterAgent\x12&.banyandb.fodc.v1.RegisterAgentRequest\x1a\'.banyandb.fodc.v1.RegisterAgentResponse(\x01\x30\x01\x12\x64\n\rStreamMetrics\x12&.banyandb.fodc.v1.StreamMetricsRequest\x1a\'.banyandb.fodc.v1.StreamMetricsResponse(\x01\x30\x01\x12|\n\x15StreamClusterTopology\x12..banyandb.fodc.v1.StreamClusterTopologyRequest\x1a/.banyandb.fodc.v1.StreamClusterTopologyResponse(\x01\x30\x01\x12j\n\x0fStreamLifecycle\x12(.banyandb.fodc.v1.StreamLifecycleRequest\x1a).banyandb.fodc.v1.StreamLifecycleResponse(\x01\x30\x01\x12\x7f\n\x16StreamCrashDiagnostics\x12/.banyandb.fodc.v1.StreamCrashDiagnosticsRequest\x1a\x30.banyandb.fodc.v1.StreamCrashDiagnosticsResponse(\x01\x30\x01\x12\x7f\n\x16StreamPressureProfiles\x12/.banyandb.fodc.v1.StreamPressureProfilesRequest\x1a\x30.banyandb.fodc.v1.StreamPressureProfilesResponse(\x01\x30\x01\x32p\n\x15GroupLifecycleService\x12W\n\nInspectAll\x12#.banyandb.fodc.v1.InspectAllRequest\x1a$.banyandb.fodc.v1.InspectAllResponseBBZ@github.com/apache/skywalking-banyandb/api/proto/banyandb/fodc/v1b\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'banyandb_tpu_torch.api.pb.banyandb.fodc.v1.rpc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  DESCRIPTOR._serialized_options = b'Z@github.com/apache/skywalking-banyandb/api/proto/banyandb/fodc/v1'
  _REGISTERAGENTREQUEST_LABELSENTRY._options = None
  _REGISTERAGENTREQUEST_LABELSENTRY._serialized_options = b'8\001'
  _METRIC_LABELSENTRY._options = None
  _METRIC_LABELSENTRY._serialized_options = b'8\001'
  _CRASHBREADCRUMB_FIELDSENTRY._options = None
  _CRASHBREADCRUMB_FIELDSENTRY._serialized_options = b'8\001'
  _CRASHPANICRECORD_PROCESSMETADATAENTRY._options = None
  _CRASHPANICRECORD_PROCESSMETADATAENTRY._serialized_options = b'8\001'
  _METRICTYPE._serialized_start=3852
  _METRICTYPE._serialized_end=4018
  _REGISTERAGENTREQUEST._serialized_start=184
  _REGISTERAGENTREQUEST._serialized_end=383
  _REGISTERAGENTREQUEST_LABELSENTRY._serialized_start=338
  _REGISTERAGENTREQUEST_LABELSENTRY._serialized_end=383
  _REGISTERAGENTRESPONSE._serialized_start=385
  _REGISTERAGENTRESPONSE._serialized_end=496
  _STREAMMETRICSREQUEST._serialized_start=498
  _STREAMMETRICSREQUEST._serialized_end=610
  _METRIC._serialized_start=613
  _METRIC._serialized_end=863
  _METRIC_LABELSENTRY._serialized_start=338
  _METRIC_LABELSENTRY._serialized_end=383
  _STREAMMETRICSRESPONSE._serialized_start=865
  _STREAMMETRICSRESPONSE._serialized_end=982
  _CALL._serialized_start=984
  _CALL._serialized_end=1034
  _TOPOLOGY._serialized_start=1036
  _TOPOLOGY._serialized_end=1128
  _STREAMCLUSTERTOPOLOGYREQUEST._serialized_start=1130
  _STREAMCLUSTERTOPOLOGYREQUEST._serialized_end=1253
  _STREAMCLUSTERTOPOLOGYRESPONSE._serialized_start=1255
  _STREAMCLUSTERTOPOLOGYRESPONSE._serialized_end=1312
  _STREAMLIFECYCLEREQUEST._serialized_start=1315
  _STREAMLIFECYCLEREQUEST._serialized_end=1461
  _STREAMLIFECYCLERESPONSE._serialized_start=1463
  _STREAMLIFECYCLERESPONSE._serialized_end=1515
  _LIFECYCLEDATA._serialized_start=1517
  _LIFECYCLEDATA._serialized_end=1638
  _GROUPLIFECYCLEINFO._serialized_start=1641
  _GROUPLIFECYCLEINFO._serialized_end=1816
  _LIFECYCLEREPORT._serialized_start=1818
  _LIFECYCLEREPORT._serialized_end=1874
  _CRASHBREADCRUMB._serialized_start=1877
  _CRASHBREADCRUMB._serialized_end=2080
  _CRASHBREADCRUMB_FIELDSENTRY._serialized_start=2035
  _CRASHBREADCRUMB_FIELDSENTRY._serialized_end=2080
  _CRASHPANICRECORD._serialized_start=2083
  _CRASHPANICRECORD._serialized_end=2429
  _CRASHPANICRECORD_PROCESSMETADATAENTRY._serialized_start=2375
  _CRASHPANICRECORD_PROCESSMETADATAENTRY._serialized_end=2429
  _STREAMCRASHDIAGNOSTICSREQUEST._serialized_start=2432
  _STREAMCRASHDIAGNOSTICSREQUEST._serialized_end=2631
  _STREAMCRASHDIAGNOSTICSRESPONSE._serialized_start=2633
  _STREAMCRASHDIAGNOSTICSRESPONSE._serialized_end=2694
  _PRESSUREPROFILEINFO._serialized_start=2696
  _PRESSUREPROFILEINFO._serialized_end=2803
  _PRESSUREPROFILERECORD._serialized_start=2806
  _PRESSUREPROFILERECORD._serialized_end=3077
  _PRESSUREPROFILECHUNK._serialized_start=3079
  _PRESSUREPROFILECHUNK._serialized_end=3198
  _STREAMPRESSUREPROFILESREQUEST._serialized_start=3201
  _STREAMPRESSUREPROFILESREQUEST._serialized_end=3416
  _LISTCOMPLETE._serialized_start=3418
  _LISTCOMPLETE._serialized_end=3452
  _FETCHPRESSUREPROFILE._serialized_start=3454
  _FETCHPRESSUREPROFILE._serialized_end=3548
  _STREAMPRESSUREPROFILESRESPONSE._serialized_start=3551
  _STREAMPRESSUREPROFILESRESPONSE._serialized_end=3716
  _LISTPROFILES._serialized_start=3718
  _LISTPROFILES._serialized_end=3752
  _INSPECTALLREQUEST._serialized_start=3754
  _INSPECTALLREQUEST._serialized_end=3773
  _INSPECTALLRESPONSE._serialized_start=3775
  _INSPECTALLRESPONSE._serialized_end=3849
  _FODCSERVICE._serialized_start=4021
  _FODCSERVICE._serialized_end=4730
  _GROUPLIFECYCLESERVICE._serialized_start=4732
  _GROUPLIFECYCLESERVICE._serialized_end=4844
# @@protoc_insertion_point(module_scope)
