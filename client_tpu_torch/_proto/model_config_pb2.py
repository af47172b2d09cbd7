# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: model_config.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12model_config.proto\x12\tinference\"#\n\x12ModelTensorReshape\x12\r\n\x05shape\x18\x01 \x03(\x03\"\xb2\x02\n\nModelInput\x12\x0c\n\x04name\x18\x01 \x01(\t\x12&\n\tdata_type\x18\x02 \x01(\x0e\x32\x13.inference.DataType\x12,\n\x06\x66ormat\x18\x03 \x01(\x0e\x32\x1c.inference.ModelInput.Format\x12\x0c\n\x04\x64ims\x18\x04 \x03(\x03\x12.\n\x07reshape\x18\x05 \x01(\x0b\x32\x1d.inference.ModelTensorReshape\x12\x17\n\x0fis_shape_tensor\x18\x06 \x01(\x08\x12\x1a\n\x12\x61llow_ragged_batch\x18\x07 \x01(\x08\x12\x10\n\x08optional\x18\x08 \x01(\x08\";\n\x06\x46ormat\x12\x0f\n\x0b\x46ORMAT_NONE\x10\x00\x12\x0f\n\x0b\x46ORMAT_NHWC\x10\x01\x12\x0f\n\x0b\x46ORMAT_NCHW\x10\x02\"\xb2\x01\n\x0bModelOutput\x12\x0c\n\x04name\x18\x01 \x01(\t\x12&\n\tdata_type\x18\x02 \x01(\x0e\x32\x13.inference.DataType\x12\x0c\n\x04\x64ims\x18\x03 \x03(\x03\x12\x16\n\x0elabel_filename\x18\x04 \x01(\t\x12.\n\x07reshape\x18\x05 \x01(\x0b\x32\x1d.inference.ModelTensorReshape\x12\x17\n\x0fis_shape_tensor\x18\x06 \x01(\x08\"\x90\x02\n\x12ModelVersionPolicy\x12\x36\n\x06latest\x18\x01 \x01(\x0b\x32$.inference.ModelVersionPolicy.LatestH\x00\x12\x30\n\x03\x61ll\x18\x02 \x01(\x0b\x32!.inference.ModelVersionPolicy.AllH\x00\x12:\n\x08specific\x18\x03 \x01(\x0b\x32&.inference.ModelVersionPolicy.SpecificH\x00\x1a\x1e\n\x06Latest\x12\x14\n\x0cnum_versions\x18\x01 \x01(\r\x1a\x05\n\x03\x41ll\x1a\x1c\n\x08Specific\x12\x10\n\x08versions\x18\x01 \x03(\x03\x42\x0f\n\rpolicy_choice\"\xb4\x01\n\x12ModelInstanceGroup\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\r\n\x05\x63ount\x18\x02 \x01(\x05\x12\x0c\n\x04gpus\x18\x03 \x03(\x05\x12\x30\n\x04kind\x18\x04 \x01(\x0e\x32\".inference.ModelInstanceGroup.Kind\"A\n\x04Kind\x12\r\n\tKIND_AUTO\x10\x00\x12\x0c\n\x08KIND_GPU\x10\x01\x12\x0c\n\x08KIND_CPU\x10\x02\x12\x0e\n\nKIND_MODEL\x10\x03\"\xdb\x01\n\x10ModelQueuePolicy\x12\x41\n\x0etimeout_action\x18\x01 \x01(\x0e\x32).inference.ModelQueuePolicy.TimeoutAction\x12$\n\x1c\x64\x65\x66\x61ult_timeout_microseconds\x18\x02 \x01(\x04\x12\x1e\n\x16\x61llow_timeout_override\x18\x03 \x01(\x08\x12\x16\n\x0emax_queue_size\x18\x04 \x01(\r\"&\n\rTimeoutAction\x12\n\n\x06REJECT\x10\x00\x12\t\n\x05\x44\x45LAY\x10\x01\"\x9b\x03\n\x14ModelDynamicBatching\x12\x1c\n\x14preferred_batch_size\x18\x01 \x03(\x05\x12$\n\x1cmax_queue_delay_microseconds\x18\x02 \x01(\x04\x12\x19\n\x11preserve_ordering\x18\x03 \x01(\x08\x12\x17\n\x0fpriority_levels\x18\x04 \x01(\x04\x12\x1e\n\x16\x64\x65\x66\x61ult_priority_level\x18\x05 \x01(\x04\x12\x39\n\x14\x64\x65\x66\x61ult_queue_policy\x18\x06 \x01(\x0b\x32\x1b.inference.ModelQueuePolicy\x12W\n\x15priority_queue_policy\x18\x07 \x03(\x0b\x32\x38.inference.ModelDynamicBatching.PriorityQueuePolicyEntry\x1aW\n\x18PriorityQueuePolicyEntry\x12\x0b\n\x03key\x18\x01 \x01(\x04\x12*\n\x05value\x18\x02 \x01(\x0b\x32\x1b.inference.ModelQueuePolicy:\x02\x38\x01\"\xfc\x06\n\x15ModelSequenceBatching\x12\x41\n\x06\x64irect\x18\x03 \x01(\x0b\x32/.inference.ModelSequenceBatching.StrategyDirectH\x00\x12\x41\n\x06oldest\x18\x04 \x01(\x0b\x32/.inference.ModelSequenceBatching.StrategyOldestH\x00\x12&\n\x1emax_sequence_idle_microseconds\x18\x01 \x01(\x04\x12\x44\n\rcontrol_input\x18\x02 \x03(\x0b\x32-.inference.ModelSequenceBatching.ControlInput\x1a\xb1\x02\n\x07\x43ontrol\x12;\n\x04kind\x18\x01 \x01(\x0e\x32-.inference.ModelSequenceBatching.Control.Kind\x12\x18\n\x10int32_false_true\x18\x02 \x03(\x05\x12\x17\n\x0f\x66p32_false_true\x18\x03 \x03(\x02\x12&\n\tdata_type\x18\x04 \x01(\x0e\x32\x13.inference.DataType\x12\x17\n\x0f\x62ool_false_true\x18\x05 \x03(\x08\"u\n\x04Kind\x12\x1a\n\x16\x43ONTROL_SEQUENCE_START\x10\x00\x12\x1a\n\x16\x43ONTROL_SEQUENCE_READY\x10\x01\x12\x18\n\x14\x43ONTROL_SEQUENCE_END\x10\x02\x12\x1b\n\x17\x43ONTROL_SEQUENCE_CORRID\x10\x03\x1aW\n\x0c\x43ontrolInput\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x39\n\x07\x63ontrol\x18\x02 \x03(\x0b\x32(.inference.ModelSequenceBatching.Control\x1aX\n\x0eStrategyDirect\x12$\n\x1cmax_queue_delay_microseconds\x18\x01 \x01(\x04\x12 \n\x18minimum_slot_utilization\x18\x02 \x01(\x02\x1au\n\x0eStrategyOldest\x12\x1f\n\x17max_candidate_sequences\x18\x01 \x01(\x05\x12\x1c\n\x14preferred_batch_size\x18\x02 \x03(\x05\x12$\n\x1cmax_queue_delay_microseconds\x18\x03 \x01(\x04\x42\x11\n\x0fstrategy_choice\"\xdd\x02\n\x0fModelEnsembling\x12-\n\x04step\x18\x01 \x03(\x0b\x32\x1f.inference.ModelEnsembling.Step\x1a\x9a\x02\n\x04Step\x12\x12\n\nmodel_name\x18\x01 \x01(\t\x12\x15\n\rmodel_version\x18\x02 \x01(\x03\x12@\n\tinput_map\x18\x03 \x03(\x0b\x32-.inference.ModelEnsembling.Step.InputMapEntry\x12\x42\n\noutput_map\x18\x04 \x03(\x0b\x32..inference.ModelEnsembling.Step.OutputMapEntry\x1a/\n\rInputMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x30\n\x0eOutputMapEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"&\n\x0eModelParameter\x12\x14\n\x0cstring_value\x18\x01 \x01(\t\"\xf9\x01\n\x17ModelOptimizationPolicy\x12\x37\n\x05graph\x18\x01 \x01(\x0b\x32(.inference.ModelOptimizationPolicy.Graph\x12\x42\n\x08priority\x18\x02 \x01(\x0e\x32\x30.inference.ModelOptimizationPolicy.ModelPriority\x1a\x16\n\x05Graph\x12\r\n\x05level\x18\x01 \x01(\x05\"I\n\rModelPriority\x12\x14\n\x10PRIORITY_DEFAULT\x10\x00\x12\x10\n\x0cPRIORITY_MAX\x10\x01\x12\x10\n\x0cPRIORITY_MIN\x10\x02\"+\n\x16ModelTransactionPolicy\x12\x11\n\tdecoupled\x18\x01 \x01(\x08\"\xe6\x01\n\x15ModelRepositoryAgents\x12\x36\n\x06\x61gents\x18\x01 \x03(\x0b\x32&.inference.ModelRepositoryAgents.Agent\x1a\x94\x01\n\x05\x41gent\x12\x0c\n\x04name\x18\x01 \x01(\t\x12J\n\nparameters\x18\x02 \x03(\x0b\x32\x36.inference.ModelRepositoryAgents.Agent.ParametersEntry\x1a\x31\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"$\n\x12ModelResponseCache\x12\x0e\n\x06\x65nable\x18\x01 \x01(\x08\"\xf4\x08\n\x0bModelConfig\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x10\n\x08platform\x18\x02 \x01(\t\x12\x35\n\x0eversion_policy\x18\x03 \x01(\x0b\x32\x1d.inference.ModelVersionPolicy\x12\x16\n\x0emax_batch_size\x18\x04 \x01(\x05\x12$\n\x05input\x18\x05 \x03(\x0b\x32\x15.inference.ModelInput\x12&\n\x06output\x18\x06 \x03(\x0b\x32\x16.inference.ModelOutput\x12\x35\n\x0einstance_group\x18\x07 \x03(\x0b\x32\x1d.inference.ModelInstanceGroup\x12\x1e\n\x16\x64\x65\x66\x61ult_model_filename\x18\x08 \x01(\t\x12H\n\x12\x63\x63_model_filenames\x18\t \x03(\x0b\x32,.inference.ModelConfig.CcModelFilenamesEntry\x12;\n\x0bmetric_tags\x18\n \x03(\x0b\x32&.inference.ModelConfig.MetricTagsEntry\x12:\n\nparameters\x18\x0b \x03(\x0b\x32&.inference.ModelConfig.ParametersEntry\x12\x38\n\x0coptimization\x18\x0c \x01(\x0b\x32\".inference.ModelOptimizationPolicy\x12;\n\x10\x64ynamic_batching\x18\r \x01(\x0b\x32\x1f.inference.ModelDynamicBatchingH\x00\x12=\n\x11sequence_batching\x18\x0e \x01(\x0b\x32 .inference.ModelSequenceBatchingH\x00\x12\x39\n\x13\x65nsemble_scheduling\x18\x0f \x01(\x0b\x32\x1a.inference.ModelEnsemblingH\x00\x12\x43\n\x18model_transaction_policy\x18\x12 \x01(\x0b\x32!.inference.ModelTransactionPolicy\x12\x0f\n\x07\x62\x61\x63kend\x18\x13 \x01(\t\x12\x41\n\x17model_repository_agents\x18\x17 \x01(\x0b\x32 .inference.ModelRepositoryAgents\x12\x35\n\x0eresponse_cache\x18\x18 \x01(\x0b\x32\x1d.inference.ModelResponseCache\x1a\x37\n\x15\x43\x63ModelFilenamesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x31\n\x0fMetricTagsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1aL\n\x0fParametersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12(\n\x05value\x18\x02 \x01(\x0b\x32\x19.inference.ModelParameter:\x02\x38\x01\x42\x13\n\x11scheduling_choice*\xfa\x01\n\x08\x44\x61taType\x12\x10\n\x0cTYPE_INVALID\x10\x00\x12\r\n\tTYPE_BOOL\x10\x01\x12\x0e\n\nTYPE_UINT8\x10\x02\x12\x0f\n\x0bTYPE_UINT16\x10\x03\x12\x0f\n\x0bTYPE_UINT32\x10\x04\x12\x0f\n\x0bTYPE_UINT64\x10\x05\x12\r\n\tTYPE_INT8\x10\x06\x12\x0e\n\nTYPE_INT16\x10\x07\x12\x0e\n\nTYPE_INT32\x10\x08\x12\x0e\n\nTYPE_INT64\x10\t\x12\r\n\tTYPE_FP16\x10\n\x12\r\n\tTYPE_FP32\x10\x0b\x12\r\n\tTYPE_FP64\x10\x0c\x12\x0f\n\x0bTYPE_STRING\x10\r\x12\r\n\tTYPE_BF16\x10\x0e\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'model_config_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MODELDYNAMICBATCHING_PRIORITYQUEUEPOLICYENTRY._options = None
  _MODELDYNAMICBATCHING_PRIORITYQUEUEPOLICYENTRY._serialized_options = b'8\001'
  _MODELENSEMBLING_STEP_INPUTMAPENTRY._options = None
  _MODELENSEMBLING_STEP_INPUTMAPENTRY._serialized_options = b'8\001'
  _MODELENSEMBLING_STEP_OUTPUTMAPENTRY._options = None
  _MODELENSEMBLING_STEP_OUTPUTMAPENTRY._serialized_options = b'8\001'
  _MODELREPOSITORYAGENTS_AGENT_PARAMETERSENTRY._options = None
  _MODELREPOSITORYAGENTS_AGENT_PARAMETERSENTRY._serialized_options = b'8\001'
  _MODELCONFIG_CCMODELFILENAMESENTRY._options = None
  _MODELCONFIG_CCMODELFILENAMESENTRY._serialized_options = b'8\001'
  _MODELCONFIG_METRICTAGSENTRY._options = None
  _MODELCONFIG_METRICTAGSENTRY._serialized_options = b'8\001'
  _MODELCONFIG_PARAMETERSENTRY._options = None
  _MODELCONFIG_PARAMETERSENTRY._serialized_options = b'8\001'
  _DATATYPE._serialized_start=4653
  _DATATYPE._serialized_end=4903
  _MODELTENSORRESHAPE._serialized_start=33
  _MODELTENSORRESHAPE._serialized_end=68
  _MODELINPUT._serialized_start=71
  _MODELINPUT._serialized_end=377
  _MODELINPUT_FORMAT._serialized_start=318
  _MODELINPUT_FORMAT._serialized_end=377
  _MODELOUTPUT._serialized_start=380
  _MODELOUTPUT._serialized_end=558
  _MODELVERSIONPOLICY._serialized_start=561
  _MODELVERSIONPOLICY._serialized_end=833
  _MODELVERSIONPOLICY_LATEST._serialized_start=749
  _MODELVERSIONPOLICY_LATEST._serialized_end=779
  _MODELVERSIONPOLICY_ALL._serialized_start=781
  _MODELVERSIONPOLICY_ALL._serialized_end=786
  _MODELVERSIONPOLICY_SPECIFIC._serialized_start=788
  _MODELVERSIONPOLICY_SPECIFIC._serialized_end=816
  _MODELINSTANCEGROUP._serialized_start=836
  _MODELINSTANCEGROUP._serialized_end=1016
  _MODELINSTANCEGROUP_KIND._serialized_start=951
  _MODELINSTANCEGROUP_KIND._serialized_end=1016
  _MODELQUEUEPOLICY._serialized_start=1019
  _MODELQUEUEPOLICY._serialized_end=1238
  _MODELQUEUEPOLICY_TIMEOUTACTION._serialized_start=1200
  _MODELQUEUEPOLICY_TIMEOUTACTION._serialized_end=1238
  _MODELDYNAMICBATCHING._serialized_start=1241
  _MODELDYNAMICBATCHING._serialized_end=1652
  _MODELDYNAMICBATCHING_PRIORITYQUEUEPOLICYENTRY._serialized_start=1565
  _MODELDYNAMICBATCHING_PRIORITYQUEUEPOLICYENTRY._serialized_end=1652
  _MODELSEQUENCEBATCHING._serialized_start=1655
  _MODELSEQUENCEBATCHING._serialized_end=2547
  _MODELSEQUENCEBATCHING_CONTROL._serialized_start=1925
  _MODELSEQUENCEBATCHING_CONTROL._serialized_end=2230
  _MODELSEQUENCEBATCHING_CONTROL_KIND._serialized_start=2113
  _MODELSEQUENCEBATCHING_CONTROL_KIND._serialized_end=2230
  _MODELSEQUENCEBATCHING_CONTROLINPUT._serialized_start=2232
  _MODELSEQUENCEBATCHING_CONTROLINPUT._serialized_end=2319
  _MODELSEQUENCEBATCHING_STRATEGYDIRECT._serialized_start=2321
  _MODELSEQUENCEBATCHING_STRATEGYDIRECT._serialized_end=2409
  _MODELSEQUENCEBATCHING_STRATEGYOLDEST._serialized_start=2411
  _MODELSEQUENCEBATCHING_STRATEGYOLDEST._serialized_end=2528
  _MODELENSEMBLING._serialized_start=2550
  _MODELENSEMBLING._serialized_end=2899
  _MODELENSEMBLING_STEP._serialized_start=2617
  _MODELENSEMBLING_STEP._serialized_end=2899
  _MODELENSEMBLING_STEP_INPUTMAPENTRY._serialized_start=2802
  _MODELENSEMBLING_STEP_INPUTMAPENTRY._serialized_end=2849
  _MODELENSEMBLING_STEP_OUTPUTMAPENTRY._serialized_start=2851
  _MODELENSEMBLING_STEP_OUTPUTMAPENTRY._serialized_end=2899
  _MODELPARAMETER._serialized_start=2901
  _MODELPARAMETER._serialized_end=2939
  _MODELOPTIMIZATIONPOLICY._serialized_start=2942
  _MODELOPTIMIZATIONPOLICY._serialized_end=3191
  _MODELOPTIMIZATIONPOLICY_GRAPH._serialized_start=3094
  _MODELOPTIMIZATIONPOLICY_GRAPH._serialized_end=3116
  _MODELOPTIMIZATIONPOLICY_MODELPRIORITY._serialized_start=3118
  _MODELOPTIMIZATIONPOLICY_MODELPRIORITY._serialized_end=3191
  _MODELTRANSACTIONPOLICY._serialized_start=3193
  _MODELTRANSACTIONPOLICY._serialized_end=3236
  _MODELREPOSITORYAGENTS._serialized_start=3239
  _MODELREPOSITORYAGENTS._serialized_end=3469
  _MODELREPOSITORYAGENTS_AGENT._serialized_start=3321
  _MODELREPOSITORYAGENTS_AGENT._serialized_end=3469
  _MODELREPOSITORYAGENTS_AGENT_PARAMETERSENTRY._serialized_start=3420
  _MODELREPOSITORYAGENTS_AGENT_PARAMETERSENTRY._serialized_end=3469
  _MODELRESPONSECACHE._serialized_start=3471
  _MODELRESPONSECACHE._serialized_end=3507
  _MODELCONFIG._serialized_start=3510
  _MODELCONFIG._serialized_end=4650
  _MODELCONFIG_CCMODELFILENAMESENTRY._serialized_start=4445
  _MODELCONFIG_CCMODELFILENAMESENTRY._serialized_end=4500
  _MODELCONFIG_METRICTAGSENTRY._serialized_start=4502
  _MODELCONFIG_METRICTAGSENTRY._serialized_end=4551
  _MODELCONFIG_PARAMETERSENTRY._serialized_start=4553
  _MODELCONFIG_PARAMETERSENTRY._serialized_end=4629
# @@protoc_insertion_point(module_scope)
