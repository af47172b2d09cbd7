// A line-oriented front end of the codec (kserve_wire.h), for tests that hold
// it against protobuf's own encoding.  One command a line on stdin, one
// answer a line on stdout.  Every string or bytes token is "x" followed
// by its hex; a double parameter's value is the 16 hex digits of its bits.
//
//   request TOKENS...      -> "ok xHEX" (the encoded ModelInferRequest)
//   response xHEX          -> "ok TOKENS..." (the decoded ModelInferResponse)
//   stream xHEX            -> "ok TOKENS..." (a ModelStreamInferResponse)
//   (a malformed message)  -> "malformed"
//
// The management and shared-memory requests (each -> "ok xHEX"):
//   model_request S S, name_request S, repository_request S S,
//   system_register S S OFFSET SIZE, cuda_register S S DEVICE SIZE.
// The responses of kserve_messages.h, read through their accessors (each
// xHEX -> "ok WORDS..."): flag (ready 0|1), empty (no words), server_metadata (name S
// version S), model_metadata (name S, then input|output S S N d1..dN a
// tensor), model_config (max_batch_size N), repository_index (models N),
// model_statistics (stat S success N a model), system_status (region K S
// S OFFSET SIZE a region), cuda_status (region K S DEVICE SIZE a region).
//
// Request tokens: model S, version S, id S, param S P, input S S N d1..dN,
// iparam S P (of the last input), output S, oparam S P (of the last
// output), raw K S1..SK (one raw_input_contents entry of K pieces).
// A parameter P is "b 0|1", "i INT", "s S", "d BITS" or "n" (no member).
// Response tokens: model, version, id, final 0|1, error S, then param,
// output S S N d1..dN, oparam, bytes S (of the last output), raw S.
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#include "kserve_messages.h"
#include "kserve_wire.h"

namespace {

using ctpu::wire::Param;
using ctpu::wire::Params;

std::string
Hex(std::string_view bytes)
{
  static const char* digits = "0123456789abcdef";
  std::string out = "x";
  for (const char c : bytes) {
    out.push_back(digits[(static_cast<uint8_t>(c) >> 4) & 0xf]);
    out.push_back(digits[static_cast<uint8_t>(c) & 0xf]);
  }
  return out;
}

std::string
Unhex(const std::string& token)
{
  std::string out;
  for (size_t i = 1; i + 1 < token.size(); i += 2)
    out.push_back(static_cast<char>(std::stoi(token.substr(i, 2), nullptr, 16)));
  return out;
}

Param
ReadParam(std::istream& in)
{
  std::string kind, value;
  in >> kind;
  if (kind == "n") return Param();
  in >> value;
  if (kind == "b") return Param::Bool(value == "1");
  if (kind == "i") return Param::Int64(std::stoll(value));
  if (kind == "s") return Param::String(Unhex(value));
  const uint64_t bits = std::stoull(value, nullptr, 16);
  double d;
  std::memcpy(&d, &bits, sizeof(d));
  return Param::Double(d);
}

void
WriteParam(std::ostream& out, const Param& p)
{
  switch (p.kind) {
    case Param::Kind::NONE:
      out << "n";
      break;
    case Param::Kind::BOOL:
      out << "b " << (p.bool_param ? 1 : 0);
      break;
    case Param::Kind::INT64:
      out << "i " << p.int64_param;
      break;
    case Param::Kind::STRING:
      out << "s " << Hex(p.string_param);
      break;
    case Param::Kind::DOUBLE: {
      uint64_t bits;
      std::memcpy(&bits, &p.double_param, sizeof(bits));
      char buf[20];
      std::snprintf(buf, sizeof(buf), "d %016llx",
                    static_cast<unsigned long long>(bits));
      out << buf;
      break;
    }
  }
}

void
WriteParams(std::ostream& out, const char* word, const Params& params)
{
  for (const auto& kv : params) {
    out << " " << word << " " << Hex(kv.first) << " ";
    WriteParam(out, kv.second);
  }
}

std::vector<int64_t>
ReadShape(std::istream& in)
{
  size_t n;
  in >> n;
  std::vector<int64_t> shape(n);
  for (auto& d : shape) in >> d;
  return shape;
}

std::string
EncodeRequest(std::istream& in)
{
  ctpu::wire::ModelInferRequest req;
  std::vector<std::string> pieces_owned;  // the raw pieces' storage
  std::vector<std::vector<size_t>> raw_pieces;
  std::string word;
  while (in >> word) {
    std::string a, b;
    if (word == "model") {
      in >> a;
      req.model_name = Unhex(a);
    } else if (word == "version") {
      in >> a;
      req.model_version = Unhex(a);
    } else if (word == "id") {
      in >> a;
      req.id = Unhex(a);
    } else if (word == "param") {
      in >> a;
      req.parameters[Unhex(a)] = ReadParam(in);
    } else if (word == "input") {
      in >> a >> b;
      req.inputs.push_back({Unhex(a), Unhex(b), ReadShape(in), {}});
    } else if (word == "iparam") {
      in >> a;
      req.inputs.back().parameters[Unhex(a)] = ReadParam(in);
    } else if (word == "output") {
      in >> a;
      req.outputs.push_back({Unhex(a), {}});
    } else if (word == "oparam") {
      in >> a;
      req.outputs.back().parameters[Unhex(a)] = ReadParam(in);
    } else if (word == "raw") {
      size_t k;
      in >> k;
      raw_pieces.emplace_back();
      for (size_t i = 0; i < k; ++i) {
        in >> a;
        raw_pieces.back().push_back(pieces_owned.size());
        pieces_owned.push_back(Unhex(a));
      }
    }
  }
  for (const auto& entry : raw_pieces) {
    req.raw_input_contents.emplace_back();
    for (const size_t i : entry)
      req.raw_input_contents.back().emplace_back(pieces_owned[i]);
  }
  std::string out;
  ctpu::wire::EncodeModelInferRequest(req, &out);
  return "ok " + Hex(out);
}

std::string
DescribeResponse(
    const ctpu::wire::ModelInferResponse& r, const std::string& error)
{
  std::ostringstream out;
  out << "ok model " << Hex(r.model_name) << " version "
      << Hex(r.model_version) << " id " << Hex(r.id) << " final "
      << (ctpu::wire::IsFinalResponse(r.parameters) ? 1 : 0) << " error "
      << Hex(error);
  WriteParams(out, "param", r.parameters);
  for (const auto& o : r.outputs) {
    out << " output " << Hex(o.name) << " " << Hex(o.datatype) << " "
        << o.shape.size();
    for (const int64_t d : o.shape) out << " " << d;
    WriteParams(out, "oparam", o.parameters);
    for (const auto& s : o.bytes_contents) out << " bytes " << Hex(s);
  }
  for (const auto& raw : r.raw_output_contents) out << " raw " << Hex(raw);
  return out.str();
}

void
WriteTensors(
    std::ostream& out, const char* word,
    const inference::ModelMetadataResponse& m, bool inputs)
{
  const int n = inputs ? m.inputs_size() : m.outputs_size();
  for (int i = 0; i < n; ++i) {
    const auto& t = inputs ? m.inputs(i) : m.outputs(i);
    out << " " << word << " " << Hex(t.name()) << " " << Hex(t.datatype())
        << " " << t.shape().size();
    for (const int64_t d : t.shape()) out << " " << d;
  }
}

// The answer to a command of the management and shared-memory messages,
// or "" where *command* is none of them.
std::string
ManagementAnswer(const std::string& command, std::istream& in)
{
  std::string a, b, c, d;
  std::ostringstream out;
  out << "ok";
  if (command == "model_request") {
    in >> a >> b;
    return "ok " + Hex(ctpu::wire::EncodeModelRequest(Unhex(a), Unhex(b)));
  }
  if (command == "name_request") {
    in >> a;
    return "ok " + Hex(ctpu::wire::EncodeNameRequest(Unhex(a)));
  }
  if (command == "repository_request") {
    in >> a >> b;
    return "ok " +
           Hex(ctpu::wire::EncodeRepositoryModelRequest(Unhex(a), Unhex(b)));
  }
  if (command == "system_register") {
    in >> a >> b >> c >> d;
    return "ok " + Hex(ctpu::wire::EncodeSystemSharedMemoryRegisterRequest(
                       Unhex(a), Unhex(b), std::stoull(c), std::stoull(d)));
  }
  if (command == "cuda_register") {
    in >> a >> b >> c >> d;
    return "ok " + Hex(ctpu::wire::EncodeCudaSharedMemoryRegisterRequest(
                       Unhex(a), Unhex(b), std::stoll(c), std::stoull(d)));
  }
  in >> a;
  const std::string bytes = Unhex(a);
  if (command == "flag") {
    bool flag;
    if (!ctpu::wire::DecodeFlagResponse(bytes, &flag)) return "malformed";
    out << " ready " << (flag ? 1 : 0);
  } else if (command == "empty") {
    if (!ctpu::wire::DecodeEmptyResponse(bytes)) return "malformed";
  } else if (command == "server_metadata") {
    inference::ServerMetadataResponse m;
    if (!m.ParseFromString(bytes)) return "malformed";
    out << " name " << Hex(m.name()) << " version " << Hex(m.version());
  } else if (command == "model_metadata") {
    inference::ModelMetadataResponse m;
    if (!m.ParseFromString(bytes)) return "malformed";
    out << " name " << Hex(m.name());
    WriteTensors(out, "input", m, true);
    WriteTensors(out, "output", m, false);
  } else if (command == "model_config") {
    inference::ModelConfigResponse m;
    if (!m.ParseFromString(bytes)) return "malformed";
    out << " max_batch_size " << m.config().max_batch_size();
  } else if (command == "repository_index") {
    inference::RepositoryIndexResponse m;
    if (!m.ParseFromString(bytes)) return "malformed";
    out << " models " << m.models_size();
  } else if (command == "model_statistics") {
    inference::ModelStatisticsResponse m;
    if (!m.ParseFromString(bytes)) return "malformed";
    for (const auto& s : m.model_stats())
      out << " stat " << Hex(s.name()) << " success "
          << s.inference_stats().success().count();
  } else if (command == "system_status") {
    inference::SystemSharedMemoryStatusResponse m;
    if (!m.ParseFromString(bytes)) return "malformed";
    for (const auto& kv : m.regions())
      out << " region " << Hex(kv.first) << " " << Hex(kv.second.name())
          << " " << Hex(kv.second.key()) << " " << kv.second.offset() << " "
          << kv.second.byte_size();
  } else if (command == "cuda_status") {
    inference::CudaSharedMemoryStatusResponse m;
    if (!m.ParseFromString(bytes)) return "malformed";
    for (const auto& kv : m.regions())
      out << " region " << Hex(kv.first) << " " << Hex(kv.second.name())
          << " " << kv.second.device_id() << " " << kv.second.byte_size();
  } else {
    return "";
  }
  return out.str();
}

}  // namespace

int
main()
{
  std::string line;
  while (std::getline(std::cin, line)) {
    std::istringstream in(line);
    std::string command, arg;
    in >> command;
    std::string answer = "malformed";
    if (command == "request") {
      answer = EncodeRequest(in);
    } else if (command == "response") {
      in >> arg;
      const std::string bytes = Unhex(arg);
      ctpu::wire::ModelInferResponse r;
      if (ctpu::wire::DecodeModelInferResponse(bytes, &r))
        answer = DescribeResponse(r, "");
    } else if (command == "stream") {
      in >> arg;
      const std::string bytes = Unhex(arg);
      ctpu::wire::ModelStreamInferResponse r;
      if (ctpu::wire::DecodeModelStreamInferResponse(bytes, &r))
        answer = DescribeResponse(r.infer_response, r.error_message);
    } else {
      const std::string managed = ManagementAnswer(command, in);
      if (!managed.empty()) answer = managed;
    }
    std::cout << answer << "\n" << std::flush;
  }
  return 0;
}
