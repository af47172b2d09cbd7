// A protobuf-free codec for the KServe-v2 messages the port's C++ gRPC
// client sends and reads, with the field numbers of proto/inference.proto:
// InferParameter, ModelInferRequest, ModelInferResponse and
// ModelStreamInferResponse (the native load worker's), the management and
// shared-memory requests, the live/ready responses, and the responses of
// kserve_messages.h (their MergeFromString is defined here).  proto3 is written and read by hand: varints,
// two's-complement int64 (no zigzag), length-delimited fields, packed
// repeated int64 `shape` (unpacked accepted on decode), map entries as
// field-1 key / field-2 value messages, and InferParameter's oneof (the
// last member on the wire wins, as in protobuf).
//
// Encoding writes only what the client puts on the wire: typed `contents`
// are never sent (raw_input_contents carries every wire input).  Decoding
// skips unknown fields of every wire type; of InferTensorContents it keeps
// bytes_contents, the classification-extension strings.
//
// Raw tensor bytes are not copied into an intermediate message: a request's
// raw_input_contents entry is a list of views, each response bytes field a
// view into the buffer that was decoded.
#pragma once

#include <cstdint>
#include <map>
#include <string>
#include <string_view>
#include <vector>

namespace ctpu {
namespace wire {

// InferParameter (oneof parameter_choice: bool 1, int64 2, string 3,
// double 4).  NONE is a parameter with no member set.
struct Param {
  enum class Kind { NONE, BOOL, INT64, STRING, DOUBLE };
  Kind kind = Kind::NONE;
  bool bool_param = false;
  int64_t int64_param = 0;
  std::string string_param;
  double double_param = 0.0;

  static Param Bool(bool v);
  static Param Int64(int64_t v);
  static Param String(const std::string& v);
  static Param Double(double v);
};
using Params = std::map<std::string, Param>;

// ModelInferRequest.InferInputTensor (without `contents`, field 5).
struct InputTensor {
  std::string name;
  std::string datatype;
  std::vector<int64_t> shape;
  Params parameters;
};

// ModelInferRequest.InferRequestedOutputTensor.
struct RequestedOutput {
  std::string name;
  Params parameters;
};

struct ModelInferRequest {
  std::string model_name;
  std::string model_version;
  std::string id;
  Params parameters;
  std::vector<InputTensor> inputs;
  std::vector<RequestedOutput> outputs;
  // One entry an input, in input order; an entry is the concatenation of
  // its pieces (InferInput's AppendRaw buffers), written straight into
  // the encoded message.
  std::vector<std::vector<std::string_view>> raw_input_contents;
};

// ModelInferResponse.InferOutputTensor.
struct OutputTensor {
  std::string name;
  std::string datatype;
  std::vector<int64_t> shape;
  Params parameters;
  std::vector<std::string_view> bytes_contents;  // contents.bytes_contents
};

struct ModelInferResponse {
  std::string model_name;
  std::string model_version;
  std::string id;
  Params parameters;
  std::vector<OutputTensor> outputs;
  std::vector<std::string_view> raw_output_contents;
};

struct ModelStreamInferResponse {
  std::string error_message;
  ModelInferResponse infer_response;
};

// Appends the encoding of *request* to *out*.
void EncodeModelInferRequest(const ModelInferRequest& request, std::string* out);

// Decode *bytes* into *out* (fields already in *out* are merged into, as
// protobuf's parse does).  The views in *out* point into *bytes*, which
// must outlive them.  False on a malformed message.
bool DecodeModelInferResponse(std::string_view bytes, ModelInferResponse* out);
bool DecodeModelStreamInferResponse(
    std::string_view bytes, ModelStreamInferResponse* out);

// The management and shared-memory requests.  ServerLive, ServerReady,
// ServerMetadata and RepositoryIndex requests are empty (no bytes).
// ModelReady-, ModelMetadata-, ModelConfig- and ModelStatisticsRequest:
// name 1, version 2.
std::string EncodeModelRequest(
    const std::string& name, const std::string& version);
// System- and CudaSharedMemoryStatusRequest, System- and
// CudaSharedMemoryUnregisterRequest: name 1.
std::string EncodeNameRequest(const std::string& name);
// RepositoryModelLoadRequest and RepositoryModelUnloadRequest: model_name
// 2, and a non-empty *config_json* as parameters["config"] (field 3, a
// ModelRepositoryParameter's string_param).
std::string EncodeRepositoryModelRequest(
    const std::string& model_name, const std::string& config_json);
// SystemSharedMemoryRegisterRequest: name 1, key 2, offset 3, byte_size 4.
std::string EncodeSystemSharedMemoryRegisterRequest(
    const std::string& name, const std::string& key, uint64_t offset,
    uint64_t byte_size);
// CudaSharedMemoryRegisterRequest: name 1, raw_handle 2 (the 64 bytes of
// a cudaIpcMemHandle_t), device_id 3, byte_size 4.
std::string EncodeCudaSharedMemoryRegisterRequest(
    const std::string& name, const std::string& raw_handle,
    int64_t device_id, uint64_t byte_size);

// ServerLiveResponse, ServerReadyResponse and ModelReadyResponse: their
// one bool, field 1 (false where absent).  False on a malformed message.
bool DecodeFlagResponse(std::string_view bytes, bool* flag);
// The responses with no fields (RepositoryModelLoad-, -UnloadResponse,
// the region register and unregister responses): whether *bytes* parse
// as a message, every field skipped.
bool DecodeEmptyResponse(std::string_view bytes);

// Whether a response's parameters mark the final response of a decoupled
// request (triton_final_response, a bool parameter).
bool IsFinalResponse(const Params& parameters);

}  // namespace wire
}  // namespace ctpu
