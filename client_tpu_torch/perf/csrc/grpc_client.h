// A KServe-v2 gRPC client without protobuf: the calls of
// src/cpp/client/grpc_client.h that the native load worker
// (src/cpp/perf/perf_worker.cc) makes, with the same namespace, class name
// and signatures, over the same HTTP/2 transport (src/cpp/grpc/h2.h,
// hpack, src/cpp/client/transport.h) and the hand-written codec of
// kserve_wire.h in place of the generated messages.
//
// The worker is compiled unedited against this header: put this
// directory on the include path ahead of src/cpp/client, and its
// `#include "grpc_client.h"` resolves here.  What is left out: the
// management and shared-memory verbs, sync Infer, the multi-request
// variants, compression, keepalive, cached channels and TLS.
#pragma once

#include <cstdint>
#include <functional>
#include <memory>
#include <mutex>
#include <string>
#include <utility>
#include <vector>

#include "common.h"
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

 private:
  InferenceServerGrpcClient(const std::string& host, int port);
  Error Connected();
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
