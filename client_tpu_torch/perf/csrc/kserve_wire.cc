#include "kserve_wire.h"

#include <cstring>

#include "kserve_messages.h"

namespace ctpu {
namespace wire {

namespace {

// proto wire types
constexpr uint32_t kVarint = 0;
constexpr uint32_t kFixed64 = 1;
constexpr uint32_t kLen = 2;
constexpr uint32_t kFixed32 = 5;

void
PutVarint(std::string* out, uint64_t v)
{
  while (v >= 0x80) {
    out->push_back(static_cast<char>((v & 0x7f) | 0x80));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

void
PutTag(std::string* out, uint32_t field, uint32_t wire_type)
{
  PutVarint(out, (static_cast<uint64_t>(field) << 3) | wire_type);
}

void
PutBytes(std::string* out, uint32_t field, std::string_view bytes)
{
  PutTag(out, field, kLen);
  PutVarint(out, bytes.size());
  out->append(bytes.data(), bytes.size());
}

// proto3: a singular string at its default (empty) is not written
void
PutString(std::string* out, uint32_t field, const std::string& s)
{
  if (!s.empty()) PutBytes(out, field, s);
}

// proto3: a singular scalar at its default (zero) is not written
void
PutVarintField(std::string* out, uint32_t field, uint64_t v)
{
  if (v == 0) return;
  PutTag(out, field, kVarint);
  PutVarint(out, v);
}

void
PutParam(std::string* out, const Param& p)
{
  // a oneof member is written even at its default value
  switch (p.kind) {
    case Param::Kind::NONE:
      break;
    case Param::Kind::BOOL:
      PutTag(out, 1, kVarint);
      PutVarint(out, p.bool_param ? 1 : 0);
      break;
    case Param::Kind::INT64:
      PutTag(out, 2, kVarint);
      PutVarint(out, static_cast<uint64_t>(p.int64_param));
      break;
    case Param::Kind::STRING:
      PutBytes(out, 3, p.string_param);
      break;
    case Param::Kind::DOUBLE: {
      PutTag(out, 4, kFixed64);
      uint64_t bits;
      std::memcpy(&bits, &p.double_param, sizeof(bits));
      for (int i = 0; i < 8; ++i)
        out->push_back(static_cast<char>((bits >> (8 * i)) & 0xff));
      break;
    }
  }
}

// map<string, InferParameter>: one field-`field` entry a key, each an
// embedded {1: key, 2: value} message
void
PutParams(std::string* out, uint32_t field, const Params& params)
{
  std::string entry, value;
  for (const auto& kv : params) {
    entry.clear();
    value.clear();
    PutBytes(&entry, 1, kv.first);
    PutParam(&value, kv.second);
    PutBytes(&entry, 2, value);
    PutBytes(out, field, entry);
  }
}

void
PutShape(std::string* out, uint32_t field, const std::vector<int64_t>& shape)
{
  if (shape.empty()) return;
  std::string packed;
  for (const int64_t d : shape) PutVarint(&packed, static_cast<uint64_t>(d));
  PutBytes(out, field, packed);
}

class Reader {
 public:
  explicit Reader(std::string_view buf) : p_(buf.data()), end_(p_ + buf.size())
  {
  }

  bool AtEnd() const { return p_ == end_; }

  bool Varint(uint64_t* v)
  {
    uint64_t result = 0;
    for (int shift = 0; shift < 64; shift += 7) {
      if (p_ == end_) return false;
      const uint8_t b = static_cast<uint8_t>(*p_++);
      result |= static_cast<uint64_t>(b & 0x7f) << shift;
      if ((b & 0x80) == 0) {
        *v = result;
        return true;
      }
    }
    return false;  // more than ten bytes
  }

  bool Tag(uint32_t* field, uint32_t* wire_type)
  {
    uint64_t tag;
    if (!Varint(&tag)) return false;
    *field = static_cast<uint32_t>(tag >> 3);
    *wire_type = static_cast<uint32_t>(tag & 7);
    return *field != 0;
  }

  bool Bytes(std::string_view* out)
  {
    uint64_t len;
    if (!Varint(&len) || len > static_cast<uint64_t>(end_ - p_)) return false;
    *out = std::string_view(p_, static_cast<size_t>(len));
    p_ += len;
    return true;
  }

  bool Fixed(size_t n, uint64_t* out)
  {
    if (static_cast<size_t>(end_ - p_) < n) return false;
    uint64_t v = 0;
    for (size_t i = 0; i < n; ++i)
      v |= static_cast<uint64_t>(static_cast<uint8_t>(p_[i])) << (8 * i);
    p_ += n;
    *out = v;
    return true;
  }

  // Skips one field's value of *wire_type* (groups are not used by
  // inference.proto and are refused).
  bool Skip(uint32_t wire_type)
  {
    uint64_t v;
    std::string_view s;
    switch (wire_type) {
      case kVarint:
        return Varint(&v);
      case kFixed64:
        return Fixed(8, &v);
      case kLen:
        return Bytes(&s);
      case kFixed32:
        return Fixed(4, &v);
      default:
        return false;
    }
  }

 private:
  const char* p_;
  const char* end_;
};

// A length-delimited field's value; false where the field has another wire
// type or is cut short.
bool
LenField(Reader* r, uint32_t wire_type, std::string_view* out)
{
  return wire_type == kLen && r->Bytes(out);
}

bool
StringField(Reader* r, uint32_t wire_type, std::string* out)
{
  std::string_view s;
  if (!LenField(r, wire_type, &s)) return false;
  out->assign(s.data(), s.size());
  return true;
}

bool
DecodeParam(std::string_view bytes, Param* p)
{
  Reader r(bytes);
  uint32_t field, wt;
  while (!r.AtEnd()) {
    if (!r.Tag(&field, &wt)) return false;
    uint64_t v;
    if (field == 1 && wt == kVarint) {
      if (!r.Varint(&v)) return false;
      *p = Param::Bool(v != 0);
    } else if (field == 2 && wt == kVarint) {
      if (!r.Varint(&v)) return false;
      *p = Param::Int64(static_cast<int64_t>(v));
    } else if (field == 3 && wt == kLen) {
      std::string s;
      if (!StringField(&r, wt, &s)) return false;
      *p = Param::String(s);
    } else if (field == 4 && wt == kFixed64) {
      if (!r.Fixed(8, &v)) return false;
      double d;
      std::memcpy(&d, &v, sizeof(d));
      *p = Param::Double(d);
    } else if (!r.Skip(wt)) {
      return false;
    }
  }
  return true;
}

// One map entry (a missing key is "", a missing value a Param with no
// member set); a key seen again replaces its value.
bool
DecodeParamEntry(std::string_view bytes, Params* params)
{
  Reader r(bytes);
  std::string key;
  Param value;
  uint32_t field, wt;
  while (!r.AtEnd()) {
    if (!r.Tag(&field, &wt)) return false;
    if (field == 1 && wt == kLen) {
      if (!StringField(&r, wt, &key)) return false;
    } else if (field == 2 && wt == kLen) {
      std::string_view v;
      if (!r.Bytes(&v) || !DecodeParam(v, &value)) return false;
    } else if (!r.Skip(wt)) {
      return false;
    }
  }
  (*params)[key] = std::move(value);
  return true;
}

// repeated int64, packed (length-delimited) or one varint a value
bool
ShapeField(Reader* r, uint32_t wire_type, std::vector<int64_t>* shape)
{
  uint64_t v;
  if (wire_type == kVarint) {
    if (!r->Varint(&v)) return false;
    shape->push_back(static_cast<int64_t>(v));
    return true;
  }
  std::string_view packed;
  if (!LenField(r, wire_type, &packed)) return false;
  Reader pr(packed);
  while (!pr.AtEnd()) {
    if (!pr.Varint(&v)) return false;
    shape->push_back(static_cast<int64_t>(v));
  }
  return true;
}

bool
DecodeContents(std::string_view bytes, std::vector<std::string_view>* out)
{
  Reader r(bytes);
  uint32_t field, wt;
  while (!r.AtEnd()) {
    if (!r.Tag(&field, &wt)) return false;
    if (field == 8 && wt == kLen) {
      std::string_view s;
      if (!r.Bytes(&s)) return false;
      out->push_back(s);
    } else if (!r.Skip(wt)) {
      return false;
    }
  }
  return true;
}

bool
DecodeOutputTensor(std::string_view bytes, OutputTensor* t)
{
  Reader r(bytes);
  uint32_t field, wt;
  while (!r.AtEnd()) {
    if (!r.Tag(&field, &wt)) return false;
    std::string_view v;
    bool ok;
    if (field == 1 && wt == kLen) {
      ok = StringField(&r, wt, &t->name);
    } else if (field == 2 && wt == kLen) {
      ok = StringField(&r, wt, &t->datatype);
    } else if (field == 3 && (wt == kLen || wt == kVarint)) {
      ok = ShapeField(&r, wt, &t->shape);
    } else if (field == 4 && wt == kLen) {
      ok = r.Bytes(&v) && DecodeParamEntry(v, &t->parameters);
    } else if (field == 5 && wt == kLen) {
      ok = r.Bytes(&v) && DecodeContents(v, &t->bytes_contents);
    } else {
      ok = r.Skip(wt);
    }
    if (!ok) return false;
  }
  return true;
}

// What a field callback of DecodeFields did with the field it was given.
enum class Got { kRead, kSkip, kBad };

// Calls fn(field, wire_type, &reader) for each field of *bytes*: kRead
// where fn read the value, kSkip to skip it (an unknown field, or a known
// one with another wire type, as protobuf treats it), kBad where the value
// is malformed.  False on a malformed message.
template <class Fn>
bool
DecodeFields(std::string_view bytes, Fn fn)
{
  Reader r(bytes);
  uint32_t field, wt;
  while (!r.AtEnd()) {
    if (!r.Tag(&field, &wt)) return false;
    const Got got = fn(field, wt, &r);
    if (got == Got::kBad || (got == Got::kSkip && !r.Skip(wt)))
      return false;
  }
  return true;
}

Got
ReadString(Reader* r, std::string* out)
{
  return StringField(r, kLen, out) ? Got::kRead : Got::kBad;
}

Got
ReadVarint(Reader* r, uint64_t* out)
{
  return r->Varint(out) ? Got::kRead : Got::kBad;
}

// A singular or repeated embedded message: merged into *m.
template <class M>
Got
ReadMessage(Reader* r, M* m)
{
  std::string_view v;
  return r->Bytes(&v) && m->MergeFromString(v) ? Got::kRead : Got::kBad;
}

// One entry of a map<string, V> (key 1, value 2): a missing key is "", a
// missing value V's default; a key seen again replaces its value.
template <class V>
Got
ReadMapEntry(Reader* r, std::map<std::string, V>* map)
{
  std::string_view entry;
  if (!r->Bytes(&entry)) return Got::kBad;
  std::string key;
  V value;
  const bool ok = DecodeFields(
      entry, [&](uint32_t field, uint32_t wt, Reader* er) -> Got {
        if (wt != kLen) return Got::kSkip;
        if (field == 1) return ReadString(er, &key);
        if (field == 2) return ReadMessage(er, &value);
        return Got::kSkip;
      });
  if (!ok) return Got::kBad;
  (*map)[key] = std::move(value);
  return Got::kRead;
}

}  // namespace

Param
Param::Bool(bool v)
{
  Param p;
  p.kind = Kind::BOOL;
  p.bool_param = v;
  return p;
}

Param
Param::Int64(int64_t v)
{
  Param p;
  p.kind = Kind::INT64;
  p.int64_param = v;
  return p;
}

Param
Param::String(const std::string& v)
{
  Param p;
  p.kind = Kind::STRING;
  p.string_param = v;
  return p;
}

Param
Param::Double(double v)
{
  Param p;
  p.kind = Kind::DOUBLE;
  p.double_param = v;
  return p;
}

void
EncodeModelInferRequest(const ModelInferRequest& request, std::string* out)
{
  PutString(out, 1, request.model_name);
  PutString(out, 2, request.model_version);
  PutString(out, 3, request.id);
  PutParams(out, 4, request.parameters);
  std::string msg;
  for (const InputTensor& t : request.inputs) {
    msg.clear();
    PutString(&msg, 1, t.name);
    PutString(&msg, 2, t.datatype);
    PutShape(&msg, 3, t.shape);
    PutParams(&msg, 4, t.parameters);
    PutBytes(out, 5, msg);
  }
  for (const RequestedOutput& o : request.outputs) {
    msg.clear();
    PutString(&msg, 1, o.name);
    PutParams(&msg, 2, o.parameters);
    PutBytes(out, 6, msg);
  }
  for (const auto& pieces : request.raw_input_contents) {
    size_t size = 0;
    for (const auto& piece : pieces) size += piece.size();
    PutTag(out, 7, kLen);
    PutVarint(out, size);
    out->reserve(out->size() + size);
    for (const auto& piece : pieces) out->append(piece.data(), piece.size());
  }
}

bool
DecodeModelInferResponse(std::string_view bytes, ModelInferResponse* out)
{
  Reader r(bytes);
  uint32_t field, wt;
  while (!r.AtEnd()) {
    if (!r.Tag(&field, &wt)) return false;
    std::string_view v;
    bool ok;
    if (field == 1 && wt == kLen) {
      ok = StringField(&r, wt, &out->model_name);
    } else if (field == 2 && wt == kLen) {
      ok = StringField(&r, wt, &out->model_version);
    } else if (field == 3 && wt == kLen) {
      ok = StringField(&r, wt, &out->id);
    } else if (field == 4 && wt == kLen) {
      ok = r.Bytes(&v) && DecodeParamEntry(v, &out->parameters);
    } else if (field == 5 && wt == kLen) {
      out->outputs.emplace_back();
      ok = r.Bytes(&v) && DecodeOutputTensor(v, &out->outputs.back());
    } else if (field == 6 && wt == kLen) {
      ok = r.Bytes(&v);
      if (ok) out->raw_output_contents.push_back(v);
    } else {
      ok = r.Skip(wt);
    }
    if (!ok) return false;
  }
  return true;
}

bool
DecodeModelStreamInferResponse(
    std::string_view bytes, ModelStreamInferResponse* out)
{
  Reader r(bytes);
  uint32_t field, wt;
  while (!r.AtEnd()) {
    if (!r.Tag(&field, &wt)) return false;
    std::string_view v;
    bool ok;
    if (field == 1 && wt == kLen) {
      ok = StringField(&r, wt, &out->error_message);
    } else if (field == 2 && wt == kLen) {
      ok = r.Bytes(&v) && DecodeModelInferResponse(v, &out->infer_response);
    } else {
      ok = r.Skip(wt);
    }
    if (!ok) return false;
  }
  return true;
}

std::string
EncodeModelRequest(const std::string& name, const std::string& version)
{
  std::string out;
  PutString(&out, 1, name);
  PutString(&out, 2, version);
  return out;
}

std::string
EncodeNameRequest(const std::string& name)
{
  std::string out;
  PutString(&out, 1, name);
  return out;
}

std::string
EncodeRepositoryModelRequest(
    const std::string& model_name, const std::string& config_json)
{
  std::string out;
  PutString(&out, 2, model_name);
  if (!config_json.empty()) {
    // map<string, ModelRepositoryParameter>: {1: "config", 2: {3: json}};
    // a oneof member is written even when empty, but an empty json is
    // not sent at all
    std::string entry, value;
    PutBytes(&value, 3, config_json);
    PutBytes(&entry, 1, "config");
    PutBytes(&entry, 2, value);
    PutBytes(&out, 3, entry);
  }
  return out;
}

std::string
EncodeSystemSharedMemoryRegisterRequest(
    const std::string& name, const std::string& key, uint64_t offset,
    uint64_t byte_size)
{
  std::string out;
  PutString(&out, 1, name);
  PutString(&out, 2, key);
  PutVarintField(&out, 3, offset);
  PutVarintField(&out, 4, byte_size);
  return out;
}

std::string
EncodeCudaSharedMemoryRegisterRequest(
    const std::string& name, const std::string& raw_handle,
    int64_t device_id, uint64_t byte_size)
{
  std::string out;
  PutString(&out, 1, name);
  PutString(&out, 2, raw_handle);
  PutVarintField(&out, 3, static_cast<uint64_t>(device_id));
  PutVarintField(&out, 4, byte_size);
  return out;
}

bool
DecodeFlagResponse(std::string_view bytes, bool* flag)
{
  *flag = false;
  return DecodeFields(bytes, [&](uint32_t field, uint32_t wt, Reader* r) {
    uint64_t v;
    if (field != 1 || wt != kVarint) return Got::kSkip;
    if (!r->Varint(&v)) return Got::kBad;
    *flag = v != 0;
    return Got::kRead;
  });
}

bool
DecodeEmptyResponse(std::string_view bytes)
{
  return DecodeFields(
      bytes, [](uint32_t, uint32_t, Reader*) { return Got::kSkip; });
}

bool
IsFinalResponse(const Params& parameters)
{
  const auto it = parameters.find("triton_final_response");
  return it != parameters.end() && it->second.kind == Param::Kind::BOOL &&
         it->second.bool_param;
}

}  // namespace wire
}  // namespace ctpu

// -- the responses of kserve_messages.h --------------------------------------

namespace inference {

using ctpu::wire::DecodeFields;
using ctpu::wire::Got;
using ctpu::wire::Reader;
using ctpu::wire::ReadMapEntry;
using ctpu::wire::ReadMessage;
using ctpu::wire::ReadString;
using ctpu::wire::ReadVarint;
using ctpu::wire::kLen;
using ctpu::wire::kVarint;

bool
ServerMetadataResponse::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (wt != kLen) return Got::kSkip;
    if (field == 1) return ReadString(r, &name_);
    if (field == 2) return ReadString(r, &version_);
    return Got::kSkip;
  });
}

bool
ModelMetadataResponse::TensorMetadata::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 3 && (wt == kLen || wt == kVarint))
      return ctpu::wire::ShapeField(r, wt, &shape_) ? Got::kRead : Got::kBad;
    if (wt != kLen) return Got::kSkip;
    if (field == 1) return ReadString(r, &name_);
    if (field == 2) return ReadString(r, &datatype_);
    return Got::kSkip;
  });
}

bool
ModelMetadataResponse::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (wt != kLen) return Got::kSkip;
    if (field == 1) return ReadString(r, &name_);
    if (field == 4) return ReadMessage(r, &inputs_.emplace_back());
    if (field == 5) return ReadMessage(r, &outputs_.emplace_back());
    return Got::kSkip;
  });
}

bool
ModelConfig::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    uint64_t v;
    if (field != 4 || wt != kVarint) return Got::kSkip;
    if (ReadVarint(r, &v) == Got::kBad) return Got::kBad;
    max_batch_size_ = static_cast<int32_t>(v);  // int32: sign-extended
    return Got::kRead;
  });
}

bool
ModelConfigResponse::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kLen) return ReadMessage(r, &config_);
    return Got::kSkip;
  });
}

bool
RepositoryIndexResponse::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    std::string_view model;
    if (field != 1 || wt != kLen) return Got::kSkip;
    if (!r->Bytes(&model)) return Got::kBad;
    ++models_size_;
    return Got::kRead;
  });
}

bool
StatisticDuration::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kVarint) return ReadVarint(r, &count_);
    return Got::kSkip;
  });
}

bool
InferStatistics::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kLen) return ReadMessage(r, &success_);
    return Got::kSkip;
  });
}

bool
ModelStatistics::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (wt != kLen) return Got::kSkip;
    if (field == 1) return ReadString(r, &name_);
    if (field == 6) return ReadMessage(r, &inference_stats_);
    return Got::kSkip;
  });
}

bool
ModelStatisticsResponse::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kLen)
      return ReadMessage(r, &model_stats_.emplace_back());
    return Got::kSkip;
  });
}

bool
SystemSharedMemoryStatusResponse::RegionStatus::MergeFromString(
    std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kLen) return ReadString(r, &name_);
    if (field == 2 && wt == kLen) return ReadString(r, &key_);
    if (field == 3 && wt == kVarint) return ReadVarint(r, &offset_);
    if (field == 4 && wt == kVarint) return ReadVarint(r, &byte_size_);
    return Got::kSkip;
  });
}

bool
SystemSharedMemoryStatusResponse::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kLen) return ReadMapEntry(r, &regions_);
    return Got::kSkip;
  });
}

bool
CudaSharedMemoryStatusResponse::RegionStatus::MergeFromString(
    std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kLen) return ReadString(r, &name_);
    if (field == 2 && wt == kVarint) return ReadVarint(r, &device_id_);
    if (field == 3 && wt == kVarint) return ReadVarint(r, &byte_size_);
    return Got::kSkip;
  });
}

bool
CudaSharedMemoryStatusResponse::MergeFromString(std::string_view bytes)
{
  return DecodeFields(bytes, [this](uint32_t field, uint32_t wt, Reader* r) {
    if (field == 1 && wt == kLen) return ReadMapEntry(r, &regions_);
    return Got::kSkip;
  });
}

}  // namespace inference
