#include "kserve_wire.h"

#include <cstring>

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

bool
IsFinalResponse(const Params& parameters)
{
  const auto it = parameters.find("triton_final_response");
  return it != parameters.end() && it->second.kind == Param::Kind::BOOL &&
         it->second.bool_param;
}

}  // namespace wire
}  // namespace ctpu
