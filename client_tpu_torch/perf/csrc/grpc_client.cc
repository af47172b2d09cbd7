#include "grpc_client.h"

#include <atomic>
#include <cstring>

#include "h2.h"

namespace ctpu {

namespace {

constexpr const char* kService = "/inference.GRPCInferenceService/";

// The gRPC length-prefixed message header (flag 0: uncompressed) over the
// first five bytes of *framed*, which hold the message from byte 5 on.
void
SetLpmHeader(std::string* framed)
{
  const size_t len = framed->size() - 5;
  (*framed)[0] = 0;
  (*framed)[1] = static_cast<char>((len >> 24) & 0xff);
  (*framed)[2] = static_cast<char>((len >> 16) & 0xff);
  (*framed)[3] = static_cast<char>((len >> 8) & 0xff);
  (*framed)[4] = static_cast<char>(len & 0xff);
}

// A request encoded behind room for its LPM header, the header then set:
// the raw tensor bytes are copied once, into the frame.
std::string
FramedRequest(const wire::ModelInferRequest& request)
{
  std::string framed(5, '\0');
  wire::EncodeModelInferRequest(request, &framed);
  SetLpmHeader(&framed);
  return framed;
}

// An encoded message behind its LPM header.
std::string
Framed(const std::string& message)
{
  std::string framed(5, '\0');
  framed += message;
  SetLpmHeader(&framed);
  return framed;
}

// The Error of a call this client does not make.
Error
NotInThisClient(const char* call, const char* why)
{
  return Error(std::string(call) + " is not in the port's protobuf-free " +
               "gRPC client: " + why);
}

// Pulls one complete length-prefixed message out of *buf* (erasing it).
// Returns false when the buffer does not yet hold a complete message.
bool
TakeLpm(std::string* buf, std::string* message, bool* compressed)
{
  if (buf->size() < 5) return false;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf->data());
  *compressed = p[0] != 0;
  const uint32_t len = (uint32_t(p[1]) << 24) | (uint32_t(p[2]) << 16) |
                       (uint32_t(p[3]) << 8) | uint32_t(p[4]);
  if (buf->size() < 5u + len) return false;
  message->assign(*buf, 5, len);
  buf->erase(0, 5 + len);
  return true;
}

std::string
PercentDecode(const std::string& in)
{
  std::string out;
  for (size_t i = 0; i < in.size(); ++i) {
    if (in[i] == '%' && i + 2 < in.size()) {
      const auto hex = [](char c) -> int {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return -1;
      };
      const int hi = hex(in[i + 1]), lo = hex(in[i + 2]);
      if (hi >= 0 && lo >= 0) {
        out.push_back(static_cast<char>(hi * 16 + lo));
        i += 2;
        continue;
      }
    }
    out.push_back(in[i]);
  }
  return out;
}

std::string
GrpcTimeoutValue(uint64_t timeout_us)
{
  return std::to_string(timeout_us) + "u";
}

// grpc-status / grpc-message from trailers (falling back to the initial
// headers for trailers-only responses).
Error
GrpcStatus(const h2::Stream& stream)
{
  const std::vector<h2::Header>* sets[2] = {&stream.trailers,
                                            &stream.headers};
  for (const auto* headers : sets) {
    std::string status, message;
    for (const auto& h : *headers) {
      if (h.first == "grpc-status") status = h.second;
      if (h.first == "grpc-message") message = h.second;
    }
    if (status.empty()) continue;
    if (status == "0") return Error::Success();
    std::string msg = PercentDecode(message);
    if (msg.empty()) msg = "request failed";
    return Error("[grpc-status " + status + "] " + msg);
  }
  return Error("response carried no grpc-status");
}

std::vector<h2::Header>
RequestHeaders(
    const std::string& method, const std::string& authority,
    uint64_t timeout_us,
    const std::vector<std::pair<std::string, std::string>>& headers)
{
  std::vector<h2::Header> hdrs = {
      {":method", "POST"},
      {":scheme", "http"},
      {":path", std::string(kService) + method},
      {":authority", authority},
      {"content-type", "application/grpc"},
      {"te", "trailers"},
      {"user-agent", "ctpu-grpc-client/1.0"},
  };
  if (timeout_us > 0)
    hdrs.emplace_back("grpc-timeout", GrpcTimeoutValue(timeout_us));
  for (const auto& h : headers) hdrs.emplace_back(h.first, h.second);
  return hdrs;
}

void
SetShm(
    wire::Params* params, const std::string& region, size_t byte_size,
    size_t offset)
{
  (*params)["shared_memory_region"] = wire::Param::String(region);
  (*params)["shared_memory_byte_size"] =
      wire::Param::Int64(static_cast<int64_t>(byte_size));
  if (offset != 0)
    (*params)["shared_memory_offset"] =
        wire::Param::Int64(static_cast<int64_t>(offset));
}

// The ModelInferRequest that the reference client builds for these
// arguments (src/cpp/client/grpc_client.cc BuildInferRequest); raw input
// contents are views of the inputs' buffers.
wire::ModelInferRequest
BuildInferRequest(
    const InferOptions& options, const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs)
{
  wire::ModelInferRequest request;
  request.model_name = options.model_name;
  request.model_version = options.model_version;
  request.id = options.request_id;
  auto& params = request.parameters;
  if (!options.sequence_id_str.empty()) {
    params["sequence_id"] = wire::Param::String(options.sequence_id_str);
    params["sequence_start"] = wire::Param::Bool(options.sequence_start);
    params["sequence_end"] = wire::Param::Bool(options.sequence_end);
  } else if (options.sequence_id != 0) {
    params["sequence_id"] =
        wire::Param::Int64(static_cast<int64_t>(options.sequence_id));
    params["sequence_start"] = wire::Param::Bool(options.sequence_start);
    params["sequence_end"] = wire::Param::Bool(options.sequence_end);
  }
  if (options.priority != 0)
    params["priority"] =
        wire::Param::Int64(static_cast<int64_t>(options.priority));
  if (options.timeout_us != 0)
    params["timeout"] =
        wire::Param::Int64(static_cast<int64_t>(options.timeout_us));
  if (options.enable_empty_final_response)
    params["triton_enable_empty_final_response"] = wire::Param::Bool(true);

  for (const InferInput* input : inputs) {
    request.inputs.emplace_back();
    wire::InputTensor& tensor = request.inputs.back();
    tensor.name = input->Name();
    tensor.datatype = input->Datatype();
    tensor.shape = input->Shape();
    if (input->IsSharedMemory()) {
      SetShm(&tensor.parameters, input->SharedMemoryName(),
             input->SharedMemoryByteSize(), input->SharedMemoryOffset());
    } else {
      request.raw_input_contents.emplace_back();
      for (const auto& buf : input->Buffers())
        request.raw_input_contents.back().emplace_back(
            reinterpret_cast<const char*>(buf.first), buf.second);
    }
  }
  for (const InferRequestedOutput* output : outputs) {
    request.outputs.emplace_back();
    wire::RequestedOutput& tensor = request.outputs.back();
    tensor.name = output->Name();
    if (output->ClassCount() > 0)
      tensor.parameters["classification"] =
          wire::Param::Int64(static_cast<int64_t>(output->ClassCount()));
    if (output->IsSharedMemory())
      SetShm(&tensor.parameters, output->SharedMemoryName(),
             output->SharedMemoryByteSize(), output->SharedMemoryOffset());
  }
  return request;
}

}  // namespace

std::shared_ptr<GrpcInferResult>
GrpcInferResult::FromMessage(std::string message)
{
  auto res = std::make_shared<GrpcInferResult>();
  res->Parse(std::move(message));
  return res;
}

void
GrpcInferResult::Parse(std::string message)
{
  body_ = std::move(message);
  wire::ModelInferResponse response;
  if (!wire::DecodeModelInferResponse(body_, &response)) {
    body_.clear();
    error_ = Error("failed to parse ModelInfer response");
    return;
  }
  Fill(response);
}

std::shared_ptr<GrpcInferResult>
GrpcInferResult::FromStreamMessage(std::string message)
{
  auto res = std::make_shared<GrpcInferResult>();
  res->body_ = std::move(message);
  wire::ModelStreamInferResponse response;
  if (!wire::DecodeModelStreamInferResponse(res->body_, &response)) {
    res->error_ = Error("failed to parse stream response");
  } else if (!response.error_message.empty()) {
    // a per-request failure keeps the request id for correlation
    res->error_ = Error(response.error_message);
    res->id_ = response.infer_response.id;
  } else {
    res->Fill(response.infer_response);
    return res;
  }
  res->body_.clear();
  return res;
}

void
GrpcInferResult::Fill(const wire::ModelInferResponse& response)
{
  model_name_ = response.model_name;
  id_ = response.id;
  is_final_response_ = wire::IsFinalResponse(response.parameters);
  for (size_t i = 0; i < response.outputs.size(); ++i) {
    const wire::OutputTensor& out = response.outputs[i];
    Output o;
    o.datatype = out.datatype;
    o.shape = out.shape;
    if (i < response.raw_output_contents.size()) {
      o.data = reinterpret_cast<const uint8_t*>(
          response.raw_output_contents[i].data());
      o.byte_size = response.raw_output_contents[i].size();
    }
    o.in_shared_memory = out.parameters.count("shared_memory_region") != 0;
    for (const auto& s : out.bytes_contents)
      o.json_values.emplace_back(s.data(), s.size());
    outputs_.emplace(out.name, std::move(o));
  }
}

Error
InferenceServerGrpcClient::Create(
    std::unique_ptr<InferenceServerGrpcClient>* client, const std::string& url,
    bool /* verbose: this client logs nothing */)
{
  std::string hostport = url;
  const size_t scheme = hostport.find("://");
  if (scheme != std::string::npos) hostport = hostport.substr(scheme + 3);
  std::string host = hostport;
  int port = 8001;
  if (!hostport.empty() && hostport[0] == '[') {  // [v6-literal]:port
    const size_t close = hostport.find(']');
    if (close == std::string::npos) return Error("malformed IPv6 url");
    host = hostport.substr(1, close - 1);
    if (close + 1 < hostport.size() && hostport[close + 1] == ':')
      port = std::stoi(hostport.substr(close + 2));
  } else {
    const size_t colon = hostport.rfind(':');
    if (colon != std::string::npos) {
      host = hostport.substr(0, colon);
      port = std::stoi(hostport.substr(colon + 1));
    }
  }
  client->reset(new InferenceServerGrpcClient(host, port));
  return Error::Success();
}

InferenceServerGrpcClient::InferenceServerGrpcClient(
    const std::string& host, int port)
    : host_(host), port_(port)
{
}

InferenceServerGrpcClient::~InferenceServerGrpcClient()
{
  StopStream();
  if (conn_ != nullptr) conn_->Close();
}

Error
InferenceServerGrpcClient::Connected()
{
  std::lock_guard<std::mutex> lk(conn_mu_);
  if (conn_ != nullptr && conn_->IsOpen()) return Error::Success();
  // Close the dead connection before replacing it: Close joins its reader
  // thread, so no async callback can hold its last strong reference there.
  if (conn_ != nullptr) conn_->Close();
  conn_ = std::make_shared<h2::H2Connection>();
  return conn_->Connect(host_, port_);
}

std::shared_ptr<h2::H2Connection>
InferenceServerGrpcClient::Conn()
{
  std::lock_guard<std::mutex> lk(conn_mu_);
  return conn_;
}

Error
InferenceServerGrpcClient::Call(
    const std::string& method, const std::string& framed,
    std::string* response, uint64_t timeout_us,
    const std::vector<std::pair<std::string, std::string>>& headers)
{
  Error err = Connected();
  if (!err.IsOk()) return err;
  auto conn = Conn();  // pin across the call (reconnects swap conn_)
  const auto hdrs = RequestHeaders(
      method, host_ + ":" + std::to_string(port_), timeout_us, headers);
  int32_t sid = 0;
  err = conn->StartStream(hdrs, false, &sid);
  if (!err.IsOk()) return err;
  const int64_t deadline_ms =
      timeout_us > 0 ? static_cast<int64_t>(timeout_us / 1000) + 1 : 0;
  err = conn->SendData(
      sid, reinterpret_cast<const uint8_t*>(framed.data()), framed.size(),
      true, deadline_ms);
  if (err.IsOk()) err = conn->WaitEndStream(sid, deadline_ms);
  if (!err.IsOk()) {
    conn->ResetStream(sid, 0x8 /* CANCEL */);
    conn->ForgetStream(sid);
    return err;
  }
  auto stream = conn->GetStream(sid);
  std::string wire_bytes;
  wire_bytes.swap(stream->data);
  conn->ForgetStream(sid);
  err = GrpcStatus(*stream);
  if (!err.IsOk()) return err;
  bool rx_compressed = false;
  if (!TakeLpm(&wire_bytes, response, &rx_compressed))
    return Error(method + " response carried no message");
  if (rx_compressed)
    return Error(
        "compressed gRPC response messages are not supported (this client "
        "sends no grpc-accept-encoding)");
  return Error::Success();
}

template <class Response>
Error
InferenceServerGrpcClient::CallFor(
    const std::string& method, const std::string& request,
    Response* response)
{
  std::string message;
  Error err = Call(method, Framed(request), &message);
  if (!err.IsOk()) return err;
  if (!response->ParseFromString(message))
    return Error("failed to parse " + method + " response");
  return Error::Success();
}

namespace {

// The live / ready responses' one bool.
struct Flag {
  bool value = false;
  bool ParseFromString(std::string_view bytes)
  {
    return wire::DecodeFlagResponse(bytes, &value);
  }
};

// A response with no fields (the register, unregister, load and unload
// responses): any well-formed message.
struct Empty {
  bool ParseFromString(std::string_view bytes)
  {
    return wire::DecodeEmptyResponse(bytes);
  }
};

}  // namespace

Error
InferenceServerGrpcClient::IsServerLive(bool* live)
{
  Flag flag;
  Error err = CallFor("ServerLive", "", &flag);
  *live = err.IsOk() && flag.value;
  return err;
}

Error
InferenceServerGrpcClient::IsServerReady(bool* ready)
{
  Flag flag;
  Error err = CallFor("ServerReady", "", &flag);
  *ready = err.IsOk() && flag.value;
  return err;
}

Error
InferenceServerGrpcClient::IsModelReady(
    bool* ready, const std::string& model_name,
    const std::string& model_version)
{
  Flag flag;
  Error err = CallFor(
      "ModelReady", wire::EncodeModelRequest(model_name, model_version),
      &flag);
  *ready = err.IsOk() && flag.value;
  return err;
}

Error
InferenceServerGrpcClient::ServerMetadata(
    inference::ServerMetadataResponse* response)
{
  return CallFor("ServerMetadata", "", response);
}

Error
InferenceServerGrpcClient::ModelMetadata(
    inference::ModelMetadataResponse* response, const std::string& name,
    const std::string& version)
{
  return CallFor(
      "ModelMetadata", wire::EncodeModelRequest(name, version), response);
}

Error
InferenceServerGrpcClient::ModelConfig(
    inference::ModelConfigResponse* response, const std::string& name,
    const std::string& version)
{
  return CallFor(
      "ModelConfig", wire::EncodeModelRequest(name, version), response);
}

Error
InferenceServerGrpcClient::ModelRepositoryIndex(
    inference::RepositoryIndexResponse* response)
{
  return CallFor("RepositoryIndex", "", response);
}

Error
InferenceServerGrpcClient::LoadModel(
    const std::string& name, const std::string& config_json)
{
  Empty response;
  return CallFor(
      "RepositoryModelLoad",
      wire::EncodeRepositoryModelRequest(name, config_json), &response);
}

Error
InferenceServerGrpcClient::UnloadModel(const std::string& name)
{
  Empty response;
  return CallFor(
      "RepositoryModelUnload", wire::EncodeRepositoryModelRequest(name, ""),
      &response);
}

Error
InferenceServerGrpcClient::ModelInferenceStatistics(
    inference::ModelStatisticsResponse* response, const std::string& name,
    const std::string& version)
{
  return CallFor(
      "ModelStatistics", wire::EncodeModelRequest(name, version), response);
}

Error
InferenceServerGrpcClient::SystemSharedMemoryStatus(
    inference::SystemSharedMemoryStatusResponse* response,
    const std::string& region_name)
{
  return CallFor(
      "SystemSharedMemoryStatus", wire::EncodeNameRequest(region_name),
      response);
}

Error
InferenceServerGrpcClient::RegisterSystemSharedMemory(
    const std::string& name, const std::string& key, size_t byte_size,
    size_t offset)
{
  Empty response;
  return CallFor(
      "SystemSharedMemoryRegister",
      wire::EncodeSystemSharedMemoryRegisterRequest(
          name, key, offset, byte_size),
      &response);
}

Error
InferenceServerGrpcClient::UnregisterSystemSharedMemory(
    const std::string& name)
{
  Empty response;
  return CallFor(
      "SystemSharedMemoryUnregister", wire::EncodeNameRequest(name),
      &response);
}

Error
InferenceServerGrpcClient::CudaSharedMemoryStatus(
    inference::CudaSharedMemoryStatusResponse* response,
    const std::string& region_name)
{
  return CallFor(
      "CudaSharedMemoryStatus", wire::EncodeNameRequest(region_name),
      response);
}

Error
InferenceServerGrpcClient::RegisterCudaSharedMemory(
    const std::string& name, const std::string& raw_handle,
    size_t device_id, size_t byte_size)
{
  Empty response;
  return CallFor(
      "CudaSharedMemoryRegister",
      wire::EncodeCudaSharedMemoryRegisterRequest(
          name, raw_handle, static_cast<int64_t>(device_id), byte_size),
      &response);
}

Error
InferenceServerGrpcClient::UnregisterCudaSharedMemory(
    const std::string& name)
{
  Empty response;
  return CallFor(
      "CudaSharedMemoryUnregister", wire::EncodeNameRequest(name),
      &response);
}

Error
InferenceServerGrpcClient::RegisterTpuSharedMemory(
    const std::string&, const std::string&, int, size_t)
{
  return NotInThisClient(
      "RegisterTpuSharedMemory",
      "the port's device regions are CUDA's (RegisterCudaSharedMemory)");
}

Error
InferenceServerGrpcClient::UnregisterTpuSharedMemory(const std::string&)
{
  return NotInThisClient(
      "UnregisterTpuSharedMemory",
      "the port's device regions are CUDA's (UnregisterCudaSharedMemory)");
}

Error
InferenceServerGrpcClient::InferMulti(
    std::vector<InferResult*>*, const std::vector<InferOptions>&,
    const std::vector<std::vector<InferInput*>>&,
    const std::vector<std::vector<const InferRequestedOutput*>>&,
    const std::vector<std::pair<std::string, std::string>>&)
{
  return NotInThisClient("InferMulti", "call Infer for each request");
}

Error
InferenceServerGrpcClient::AsyncInferMulti(
    OnMultiCompleteFn, const std::vector<InferOptions>&,
    const std::vector<std::vector<InferInput*>>&,
    const std::vector<std::vector<const InferRequestedOutput*>>&,
    const std::vector<std::pair<std::string, std::string>>&)
{
  return NotInThisClient("AsyncInferMulti", "call AsyncInfer for each "
                         "request");
}

Error
InferenceServerGrpcClient::ClientInferStat(InferStat*)
{
  return NotInThisClient("ClientInferStat", "it keeps no request timers");
}

Error
InferenceServerGrpcClient::Infer(
    InferResult** result, const InferOptions& options,
    const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs,
    const std::vector<std::pair<std::string, std::string>>& headers)
{
  std::string message;
  Error err = Call(
      "ModelInfer", FramedRequest(BuildInferRequest(options, inputs, outputs)),
      &message, options.client_timeout_us, headers);
  if (!err.IsOk()) return err;
  auto* res = new GrpcInferResult();
  res->Parse(std::move(message));
  if (!res->RequestStatus().IsOk()) {
    err = res->RequestStatus();
    delete res;
    return err;
  }
  *result = res;
  return Error::Success();
}

Error
InferenceServerGrpcClient::AsyncInfer(
    OnCompleteFn callback, const InferOptions& options,
    const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs,
    const std::vector<std::pair<std::string, std::string>>& headers)
{
  if (callback == nullptr)
    return Error("AsyncInfer requires a completion callback");
  Error err = Connected();
  if (!err.IsOk()) return err;
  const std::string framed =
      FramedRequest(BuildInferRequest(options, inputs, outputs));
  const auto hdrs =
      RequestHeaders("ModelInfer", host_ + ":" + std::to_string(port_),
                     options.client_timeout_us, headers);

  // The reactor thread completes the request: on end-of-stream, decode
  // and fire the user callback.  The lambda reads the stream id from a
  // shared holder (it exists only after StartStream) and holds only a
  // WEAK connection reference: it runs on the reader thread, where
  // dropping the last strong one would make ~H2Connection join itself.
  auto conn_sp = Conn();
  auto* conn = conn_sp.get();
  std::weak_ptr<h2::H2Connection> conn_wp = conn_sp;
  auto done = std::make_shared<std::atomic<bool>>(false);
  int32_t sid = 0;
  auto sid_holder = std::make_shared<std::atomic<int32_t>>(0);
  auto user_cb = std::make_shared<OnCompleteFn>(std::move(callback));
  err = conn->StartStream(
      hdrs, false, &sid, [conn_wp, done, sid_holder, user_cb]() {
        auto pinned = conn_wp.lock();
        if (pinned == nullptr) return;  // connection already torn down
        auto* conn = pinned.get();
        const int32_t s = sid_holder->load();
        if (s == 0) return;
        auto stream = conn->GetStream(s);
        if (stream == nullptr || !stream->end_stream) return;
        if (done->exchange(true)) return;  // single completion
        std::shared_ptr<GrpcInferResult> result;
        Error status = conn->ConnectionError();
        if (status.IsOk() && stream->reset)
          status = Error("h2 stream reset (code " +
                         std::to_string(stream->rst_code) + ")");
        if (status.IsOk()) status = GrpcStatus(*stream);
        if (status.IsOk()) {
          std::string wire_bytes;
          wire_bytes.swap(stream->data);
          std::string message;
          bool rx_compressed = false;
          if (!TakeLpm(&wire_bytes, &message, &rx_compressed))
            status = Error("ModelInfer response carried no message");
          else if (rx_compressed)
            status =
                Error("compressed gRPC response messages are not supported");
          else
            result = GrpcInferResult::FromMessage(std::move(message));
        }
        conn->ForgetStream(s);
        if (result == nullptr) {
          result = std::make_shared<GrpcInferResult>();
          result->error_ = status;
        }
        (*user_cb)(result);
      });
  if (!err.IsOk()) return err;
  sid_holder->store(sid);
  // From here on the request is owned by the callback path: a send failure
  // surfaces through the stream/connection event (reset or a failed
  // connection), which fires the completion.
  const int64_t send_deadline_ms =
      options.client_timeout_us > 0
          ? static_cast<int64_t>(options.client_timeout_us / 1000) + 1
          : 0;
  Error send_err = conn->SendData(
      sid, reinterpret_cast<const uint8_t*>(framed.data()), framed.size(),
      true, send_deadline_ms);
  if (!send_err.IsOk()) conn->ResetStream(sid, 0x8 /* CANCEL */);
  // The stream may already have completed before sid_holder was set (tiny
  // responses) or via the reset above: nudge once.
  auto stream = conn->GetStream(sid);
  if (stream != nullptr && stream->end_stream && stream->on_event)
    stream->on_event();
  return Error::Success();
}

Error
InferenceServerGrpcClient::StartStream(
    OnCompleteFn callback, uint64_t stream_timeout_us,
    const std::vector<std::pair<std::string, std::string>>& headers)
{
  if (callback == nullptr)
    return Error("StartStream requires a completion callback");
  std::lock_guard<std::mutex> lk(stream_mu_);
  if (stream_sid_ != 0) return Error("stream already active");
  Error err = Connected();
  if (!err.IsOk()) return err;
  const auto hdrs =
      RequestHeaders("ModelStreamInfer", host_ + ":" + std::to_string(port_),
                     stream_timeout_us, headers);

  stream_callback_ = std::move(callback);
  stream_rx_.clear();
  stream_timeout_us_ = stream_timeout_us;
  auto conn_sp = Conn();
  auto* conn = conn_sp.get();
  std::weak_ptr<h2::H2Connection> conn_wp = conn_sp;
  int32_t sid = 0;
  err = conn->StartStream(hdrs, false, &sid, [this, conn_wp]() {
    // Reactor thread: drain complete stream messages, deliver results.
    auto pinned = conn_wp.lock();
    if (pinned == nullptr) return;
    auto* conn = pinned.get();
    std::vector<InferResultPtr> ready;
    OnCompleteFn cb;
    {
      std::lock_guard<std::mutex> lk(stream_mu_);
      // ignore events from a stale stream (streaming restarted, possibly
      // on a new connection)
      if (stream_sid_ == 0 || stream_conn_.get() != conn) return;
      auto stream = conn->GetStream(stream_sid_);
      if (stream == nullptr) return;
      cb = stream_callback_;
      conn->ReadData(stream_sid_, 0, &stream_rx_, 1);  // what is buffered
      std::string message;
      bool rx_compressed = false;
      while (TakeLpm(&stream_rx_, &message, &rx_compressed)) {
        std::shared_ptr<GrpcInferResult> res;
        if (rx_compressed) {
          res = std::make_shared<GrpcInferResult>();
          res->error_ =
              Error("compressed gRPC response messages are not supported");
        } else {
          res = GrpcInferResult::FromStreamMessage(std::move(message));
        }
        ready.emplace_back(std::move(res));
      }
      if (stream->end_stream && stream->reset) {
        auto res = std::make_shared<GrpcInferResult>();
        res->error_ = Error("stream closed (reset " +
                            std::to_string(stream->rst_code) + ")");
        ready.emplace_back(std::move(res));
      }
    }
    if (cb)
      for (auto& r : ready) cb(r);
  });
  if (!err.IsOk()) {
    stream_callback_ = nullptr;
    return err;
  }
  stream_conn_ = conn_sp;
  stream_sid_ = sid;
  return Error::Success();
}

Error
InferenceServerGrpcClient::AsyncStreamInfer(
    const InferOptions& options, const std::vector<InferInput*>& inputs,
    const std::vector<const InferRequestedOutput*>& outputs)
{
  int32_t sid;
  std::shared_ptr<h2::H2Connection> conn;
  {
    std::lock_guard<std::mutex> lk(stream_mu_);
    if (stream_sid_ == 0)
      return Error("no active stream (call StartStream first)");
    sid = stream_sid_;
    conn = stream_conn_;
  }
  const std::string framed =
      FramedRequest(BuildInferRequest(options, inputs, outputs));
  const int64_t deadline_ms =
      stream_timeout_us_ > 0
          ? static_cast<int64_t>(stream_timeout_us_ / 1000) + 1
          : 0;
  return conn->SendData(
      sid, reinterpret_cast<const uint8_t*>(framed.data()), framed.size(),
      false, deadline_ms);
}

Error
InferenceServerGrpcClient::StopStream()
{
  int32_t sid;
  std::shared_ptr<h2::H2Connection> conn;
  {
    std::lock_guard<std::mutex> lk(stream_mu_);
    if (stream_sid_ == 0) return Error::Success();
    sid = stream_sid_;
    conn = stream_conn_;
    stream_sid_ = 0;
  }
  // half-close, wait for the server to finish, then drop the state
  const int64_t deadline_ms =
      stream_timeout_us_ > 0
          ? static_cast<int64_t>(stream_timeout_us_ / 1000) + 1
          : 10000;
  Error err = conn->SendData(sid, nullptr, 0, true, deadline_ms);
  if (err.IsOk()) conn->WaitEndStream(sid, deadline_ms);
  conn->ForgetStream(sid);
  {
    std::lock_guard<std::mutex> lk(stream_mu_);
    stream_callback_ = nullptr;
    stream_conn_.reset();
    stream_rx_.clear();
  }
  return Error::Success();
}

}  // namespace ctpu
