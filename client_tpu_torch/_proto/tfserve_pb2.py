# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: tfserve.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rtfserve.proto\x12\x12tensorflow.serving\"\x82\x01\n\x10TensorShapeProto\x12\x35\n\x03\x64im\x18\x02 \x03(\x0b\x32(.tensorflow.serving.TensorShapeProto.Dim\x12\x14\n\x0cunknown_rank\x18\x03 \x01(\x08\x1a!\n\x03\x44im\x12\x0c\n\x04size\x18\x01 \x01(\x03\x12\x0c\n\x04name\x18\x02 \x01(\t\"\xa7\x02\n\x0bTensorProto\x12+\n\x05\x64type\x18\x01 \x01(\x0e\x32\x1c.tensorflow.serving.DataType\x12:\n\x0ctensor_shape\x18\x02 \x01(\x0b\x32$.tensorflow.serving.TensorShapeProto\x12\x16\n\x0etensor_content\x18\x04 \x01(\x0c\x12\x11\n\tfloat_val\x18\x05 \x03(\x02\x12\x12\n\ndouble_val\x18\x06 \x03(\x01\x12\x0f\n\x07int_val\x18\x07 \x03(\x05\x12\x12\n\nstring_val\x18\x08 \x03(\x0c\x12\x11\n\tint64_val\x18\n \x03(\x03\x12\x10\n\x08\x62ool_val\x18\x0b \x03(\x08\x12\x12\n\nuint32_val\x18\x10 \x03(\r\x12\x12\n\nuint64_val\x18\x11 \x03(\x04\"\x8d\x01\n\tModelSpec\x12\x0c\n\x04name\x18\x01 \x01(\t\x12;\n\x07version\x18\x02 \x01(\x0b\x32*.tensorflow.serving.ModelSpec.VersionValue\x12\x16\n\x0esignature_name\x18\x03 \x01(\t\x1a\x1d\n\x0cVersionValue\x12\r\n\x05value\x18\x01 \x01(\x03\"\xea\x01\n\x0ePredictRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12>\n\x06inputs\x18\x02 \x03(\x0b\x32..tensorflow.serving.PredictRequest.InputsEntry\x12\x15\n\routput_filter\x18\x03 \x03(\t\x1aN\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12.\n\x05value\x18\x02 \x01(\x0b\x32\x1f.tensorflow.serving.TensorProto:\x02\x38\x01\"\xd8\x01\n\x0fPredictResponse\x12\x31\n\nmodel_spec\x18\x02 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x41\n\x07outputs\x18\x01 \x03(\x0b\x32\x30.tensorflow.serving.PredictResponse.OutputsEntry\x1aO\n\x0cOutputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12.\n\x05value\x18\x02 \x01(\x0b\x32\x1f.tensorflow.serving.TensorProto:\x02\x38\x01\"d\n\x17GetModelMetadataRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\x12\x16\n\x0emetadata_field\x18\x02 \x03(\t\"M\n\x18GetModelMetadataResponse\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\"J\n\x15GetModelStatusRequest\x12\x31\n\nmodel_spec\x18\x01 \x01(\x0b\x32\x1d.tensorflow.serving.ModelSpec\"\xb7\x01\n\x12ModelVersionStatus\x12\x0f\n\x07version\x18\x01 \x01(\x03\x12;\n\x05state\x18\x02 \x01(\x0e\x32,.tensorflow.serving.ModelVersionStatus.State\"S\n\x05State\x12\x0b\n\x07UNKNOWN\x10\x00\x12\t\n\x05START\x10\n\x12\x0b\n\x07LOADING\x10\x14\x12\r\n\tAVAILABLE\x10\x1e\x12\r\n\tUNLOADING\x10(\x12\x07\n\x03\x45ND\x10\x32\"^\n\x16GetModelStatusResponse\x12\x44\n\x14model_version_status\x18\x01 \x03(\x0b\x32&.tensorflow.serving.ModelVersionStatus*\xb6\x01\n\x08\x44\x61taType\x12\x0e\n\nDT_INVALID\x10\x00\x12\x0c\n\x08\x44T_FLOAT\x10\x01\x12\r\n\tDT_DOUBLE\x10\x02\x12\x0c\n\x08\x44T_INT32\x10\x03\x12\x0c\n\x08\x44T_UINT8\x10\x04\x12\x0c\n\x08\x44T_INT16\x10\x05\x12\x0b\n\x07\x44T_INT8\x10\x06\x12\r\n\tDT_STRING\x10\x07\x12\x0c\n\x08\x44T_INT64\x10\t\x12\x0b\n\x07\x44T_BOOL\x10\n\x12\r\n\tDT_UINT32\x10\x16\x12\r\n\tDT_UINT64\x10\x17\x32\xda\x01\n\x11PredictionService\x12T\n\x07Predict\x12\".tensorflow.serving.PredictRequest\x1a#.tensorflow.serving.PredictResponse\"\x00\x12o\n\x10GetModelMetadata\x12+.tensorflow.serving.GetModelMetadataRequest\x1a,.tensorflow.serving.GetModelMetadataResponse\"\x00\x32y\n\x0cModelService\x12i\n\x0eGetModelStatus\x12).tensorflow.serving.GetModelStatusRequest\x1a*.tensorflow.serving.GetModelStatusResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'tfserve_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PREDICTREQUEST_INPUTSENTRY._options = None
  _PREDICTREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _PREDICTRESPONSE_OUTPUTSENTRY._options = None
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_options = b'8\001'
  _DATATYPE._serialized_start=1608
  _DATATYPE._serialized_end=1790
  _TENSORSHAPEPROTO._serialized_start=38
  _TENSORSHAPEPROTO._serialized_end=168
  _TENSORSHAPEPROTO_DIM._serialized_start=135
  _TENSORSHAPEPROTO_DIM._serialized_end=168
  _TENSORPROTO._serialized_start=171
  _TENSORPROTO._serialized_end=466
  _MODELSPEC._serialized_start=469
  _MODELSPEC._serialized_end=610
  _MODELSPEC_VERSIONVALUE._serialized_start=581
  _MODELSPEC_VERSIONVALUE._serialized_end=610
  _PREDICTREQUEST._serialized_start=613
  _PREDICTREQUEST._serialized_end=847
  _PREDICTREQUEST_INPUTSENTRY._serialized_start=769
  _PREDICTREQUEST_INPUTSENTRY._serialized_end=847
  _PREDICTRESPONSE._serialized_start=850
  _PREDICTRESPONSE._serialized_end=1066
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_start=987
  _PREDICTRESPONSE_OUTPUTSENTRY._serialized_end=1066
  _GETMODELMETADATAREQUEST._serialized_start=1068
  _GETMODELMETADATAREQUEST._serialized_end=1168
  _GETMODELMETADATARESPONSE._serialized_start=1170
  _GETMODELMETADATARESPONSE._serialized_end=1247
  _GETMODELSTATUSREQUEST._serialized_start=1249
  _GETMODELSTATUSREQUEST._serialized_end=1323
  _MODELVERSIONSTATUS._serialized_start=1326
  _MODELVERSIONSTATUS._serialized_end=1509
  _MODELVERSIONSTATUS_STATE._serialized_start=1426
  _MODELVERSIONSTATUS_STATE._serialized_end=1509
  _GETMODELSTATUSRESPONSE._serialized_start=1511
  _GETMODELSTATUSRESPONSE._serialized_end=1605
  _PREDICTIONSERVICE._serialized_start=1793
  _PREDICTIONSERVICE._serialized_end=2011
  _MODELSERVICE._serialized_start=2013
  _MODELSERVICE._serialized_end=2134
# @@protoc_insertion_point(module_scope)
