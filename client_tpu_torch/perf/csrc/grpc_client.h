// A KServe-v2 gRPC client without protobuf: the calls of
// src/cpp/client/grpc_client.h that the native load worker
// (src/cpp/perf/perf_worker.cc) and the C++ gRPC examples
// (src/cpp/examples) make, with the same namespace, class name and
// signatures, over the same HTTP/2 transport (src/cpp/grpc/h2.h, hpack,
// src/cpp/client/transport.h) and the hand-written codec of kserve_wire.h
// in place of the generated messages (the responses the examples read are
// the classes of kserve_messages.h).
//
// The worker and the examples compile unedited against this header: put
// this directory on the include path ahead of src/cpp/client, and their
// `#include "grpc_client.h"` resolves here.  Device regions are CUDA's
// (RegisterCudaSharedMemory takes the 64 bytes of a cudaIpcMemHandle_t);
// the TPU verbs are refused.  Left out: trace and log settings,
// compression, keepalive, cached channels and TLS.  The calls declared
// here and not implemented (InferMulti, AsyncInferMulti,
// ClientInferStat, the TPU verbs) return an Error that names them.
#pragma once

#include <cstdint>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

#include "common.h"
#include "kserve_messages.h"
#include "kserve_wire.h"

namespace ctpu {
namespace h2 {
class H2Connection;
}

// An InferResult decoded through kserve_wire.h: the message's bytes move
// into body_ first, and each output's data points into them.
class GrpcInferResult : public InferResult {
 public:
  // Decodes *message* (a serialized ModelInferResponse); a malformed one
  // gives a result whose RequestStatus is the error.
  static std::shared_ptr<GrpcInferResult> FromMessage(std::string message);
  // The same for a serialized ModelStreamInferResponse: a non-empty
  // error_message gives an error result with the inner response's id.
  static std::shared_ptr<GrpcInferResult> FromStreamMessage(
      std::string message);
  // Decodes *message* into this result (its RequestStatus the error of a
  // malformed one).
  void Parse(std::string message);

 private:
  void Fill(const wire::ModelInferResponse& response);
};

class InferenceServerGrpcClient {
 public:
  using OnCompleteFn = std::function<void(InferResultPtr)>;

  // url is "host:port" (no scheme) or "grpc://host:port".
  static Error Create(
      std::unique_ptr<InferenceServerGrpcClient>* client,
      const std::string& url, bool verbose = false);
  ~InferenceServerGrpcClient();

  // -- server / model management ------------------------------------------
  Error IsServerLive(bool* live);
  Error IsServerReady(bool* ready);
  Error IsModelReady(
      bool* ready, const std::string& model_name,
      const std::string& model_version = "");
  Error ServerMetadata(inference::ServerMetadataResponse* response);
  Error ModelMetadata(
      inference::ModelMetadataResponse* response, const std::string& name,
      const std::string& version = "");
  Error ModelConfig(
      inference::ModelConfigResponse* response, const std::string& name,
      const std::string& version = "");
  Error ModelRepositoryIndex(inference::RepositoryIndexResponse* response);
  Error LoadModel(
      const std::string& name, const std::string& config_json = "");
  Error UnloadModel(const std::string& name);
  Error ModelInferenceStatistics(
      inference::ModelStatisticsResponse* response,
      const std::string& name = "", const std::string& version = "");

  // -- shared memory verbs -------------------------------------------------
  Error SystemSharedMemoryStatus(
      inference::SystemSharedMemoryStatusResponse* response,
      const std::string& region_name = "");
  Error RegisterSystemSharedMemory(
      const std::string& name, const std::string& key, size_t byte_size,
      size_t offset = 0);
  Error UnregisterSystemSharedMemory(const std::string& name = "");
  // CUDA device regions: *raw_handle* is the 64 bytes of the region's
  // cudaIpcMemHandle_t (ccudashm.h's CudaShmGetRawHandle), opened by the
  // server over CUDA IPC.
  Error CudaSharedMemoryStatus(
      inference::CudaSharedMemoryStatusResponse* response,
      const std::string& region_name = "");
  Error RegisterCudaSharedMemory(
      const std::string& name, const std::string& raw_handle,
      size_t device_id, size_t byte_size);
  Error UnregisterCudaSharedMemory(const std::string& name = "");
  // Refused: the port's server holds no TPU regions.
  Error RegisterTpuSharedMemory(
      const std::string& name, const std::string& raw_handle, int device_id,
      size_t byte_size);
  Error UnregisterTpuSharedMemory(const std::string& name = "");

  // -- inference ------------------------------------------------------------
  Error Infer(
      InferResult** result, const InferOptions& options,
      const std::vector<InferInput*>& inputs,
      const std::vector<const InferRequestedOutput*>& outputs = {},
      const std::vector<std::pair<std::string, std::string>>& headers = {});
  Error AsyncInfer(
      OnCompleteFn callback, const InferOptions& options,
      const std::vector<InferInput*>& inputs,
      const std::vector<const InferRequestedOutput*>& outputs = {},
      const std::vector<std::pair<std::string, std::string>>& headers = {});

  // One bidi ModelStreamInfer stream per client.  Responses (and stream
  // errors, delivered as error results) arrive on `callback`.
  Error StartStream(
      OnCompleteFn callback, uint64_t stream_timeout_us = 0,
      const std::vector<std::pair<std::string, std::string>>& headers = {});
  Error AsyncStreamInfer(
      const InferOptions& options, const std::vector<InferInput*>& inputs,
      const std::vector<const InferRequestedOutput*>& outputs = {});
  Error StopStream();

  // Not in this client: each returns an Error that names it.
  using OnMultiCompleteFn = std::function<void(std::vector<InferResultPtr>)>;
  Error InferMulti(
      std::vector<InferResult*>* results,
      const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs =
          {},
      const std::vector<std::pair<std::string, std::string>>& headers = {});
  Error AsyncInferMulti(
      OnMultiCompleteFn callback, const std::vector<InferOptions>& options,
      const std::vector<std::vector<InferInput*>>& inputs,
      const std::vector<std::vector<const InferRequestedOutput*>>& outputs =
          {},
      const std::vector<std::pair<std::string, std::string>>& headers = {});
  using InferStat = ctpu::InferStat;
  Error ClientInferStat(InferStat* stat);

 private:
  InferenceServerGrpcClient(const std::string& host, int port);
  Error Connected();
  // One unary gRPC exchange: *framed* (an encoded message behind its LPM
  // header) sent, the response message and trailers awaited, grpc-status
  // checked; the response message's bytes into *response*.
  Error Call(
      const std::string& method, const std::string& framed,
      std::string* response, uint64_t timeout_us = 0,
      const std::vector<std::pair<std::string, std::string>>& headers = {});
  // Call with the encoded *request*, then *response*'s ParseFromString.
  template <class Response>
  Error CallFor(
      const std::string& method, const std::string& request,
      Response* response);
  std::shared_ptr<h2::H2Connection> Conn();

  std::string host_;
  int port_;
  // shared_ptr: a reconnect swaps conn_ while async callbacks may still
  // reference the old connection; each call path pins its own reference.
  std::shared_ptr<h2::H2Connection> conn_;
  std::mutex conn_mu_;

  // streaming state
  std::mutex stream_mu_;
  std::shared_ptr<h2::H2Connection> stream_conn_;  // owns stream_sid_
  int32_t stream_sid_ = 0;
  OnCompleteFn stream_callback_;
  std::string stream_rx_;  // partial length-prefixed message bytes
  uint64_t stream_timeout_us_ = 0;
};

}  // namespace ctpu
