// Minimal .npy (NumPy v1.0/2.0 format) reader/writer for C-contiguous
// little-endian arrays — the on-disk tensor format of paddle_tpu.io
// (save_persistables writes one .npy per var).
#pragma once

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace ptnpy {

enum class DType : int { F32 = 0, F64 = 1, I32 = 2, I64 = 3, U8 = 4, BOOL = 5 };

inline size_t dtype_size(DType d) {
  switch (d) {
    case DType::F32: case DType::I32: return 4;
    case DType::F64: case DType::I64: return 8;
    case DType::U8: case DType::BOOL: return 1;
  }
  return 0;
}

inline const char* dtype_descr(DType d) {
  switch (d) {
    case DType::F32: return "<f4";
    case DType::F64: return "<f8";
    case DType::I32: return "<i4";
    case DType::I64: return "<i8";
    case DType::U8: return "|u1";
    case DType::BOOL: return "|b1";
  }
  return "";
}

struct Array {
  DType dtype = DType::F32;
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;

  size_t numel() const {
    size_t n = 1;
    for (auto d : shape) n *= static_cast<size_t>(d);
    return n;
  }
  float* f32() { return reinterpret_cast<float*>(data.data()); }
  const float* f32() const { return reinterpret_cast<const float*>(data.data()); }
  int64_t* i64() { return reinterpret_cast<int64_t*>(data.data()); }
  const int64_t* i64() const { return reinterpret_cast<const int64_t*>(data.data()); }
  int32_t* i32() { return reinterpret_cast<int32_t*>(data.data()); }
  const int32_t* i32() const { return reinterpret_cast<const int32_t*>(data.data()); }
};

inline Array Load(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) throw std::runtime_error("cannot open " + path);
  char magic[8];
  if (fread(magic, 1, 8, f) != 8 || memcmp(magic, "\x93NUMPY", 6) != 0) {
    fclose(f);
    throw std::runtime_error("not an npy file: " + path);
  }
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint8_t hl[2];
    if (fread(hl, 1, 2, f) != 2) { fclose(f); throw std::runtime_error("bad npy header"); }
    header_len = hl[0] | (hl[1] << 8);
  } else {
    uint8_t hl[4];
    if (fread(hl, 1, 4, f) != 4) { fclose(f); throw std::runtime_error("bad npy header"); }
    header_len = hl[0] | (hl[1] << 8) | (hl[2] << 16) | (uint32_t(hl[3]) << 24);
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) {
    fclose(f);
    throw std::runtime_error("bad npy header");
  }

  Array arr;
  // descr
  size_t dp = header.find("'descr'");
  if (dp == std::string::npos) { fclose(f); throw std::runtime_error("no descr"); }
  size_t q1 = header.find('\'', dp + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f4") arr.dtype = DType::F32;
  else if (descr == "<f8") arr.dtype = DType::F64;
  else if (descr == "<i4") arr.dtype = DType::I32;
  else if (descr == "<i8") arr.dtype = DType::I64;
  else if (descr == "|u1") arr.dtype = DType::U8;
  else if (descr == "|b1") arr.dtype = DType::BOOL;
  else { fclose(f); throw std::runtime_error("unsupported dtype " + descr); }
  // fortran_order must be False (we only write C-contiguous)
  if (header.find("'fortran_order': True") != std::string::npos) {
    fclose(f);
    throw std::runtime_error("fortran order unsupported");
  }
  // shape tuple
  size_t sp = header.find("'shape'");
  size_t p1 = header.find('(', sp);
  size_t p2 = header.find(')', p1);
  std::string tup = header.substr(p1 + 1, p2 - p1 - 1);
  size_t pos = 0;
  while (pos < tup.size()) {
    while (pos < tup.size() && (tup[pos] == ' ' || tup[pos] == ',')) pos++;
    if (pos >= tup.size()) break;
    size_t end;
    arr.shape.push_back(std::stoll(tup.substr(pos), &end));
    pos += end;
  }
  size_t nbytes = arr.numel() * dtype_size(arr.dtype);
  arr.data.resize(nbytes);
  if (fread(arr.data.data(), 1, nbytes, f) != nbytes) {
    fclose(f);
    throw std::runtime_error("truncated npy data in " + path);
  }
  fclose(f);
  return arr;
}

inline void Save(const std::string& path, const Array& arr) {
  FILE* f = fopen(path.c_str(), "wb");
  if (!f) throw std::runtime_error("cannot open " + path);
  std::string shape = "(";
  for (size_t i = 0; i < arr.shape.size(); i++) {
    shape += std::to_string(arr.shape[i]);
    if (arr.shape.size() == 1 || i + 1 < arr.shape.size()) shape += ",";
  }
  shape += ")";
  std::string dict = std::string("{'descr': '") + dtype_descr(arr.dtype) +
                     "', 'fortran_order': False, 'shape': " + shape + ", }";
  size_t total = 10 + dict.size() + 1;
  size_t pad = (64 - total % 64) % 64;
  dict += std::string(pad, ' ');
  dict += '\n';
  uint16_t hlen = static_cast<uint16_t>(dict.size());
  fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  fwrite(&hlen, 2, 1, f);
  fwrite(dict.data(), 1, dict.size(), f);
  fwrite(arr.data.data(), 1, arr.data.size(), f);
  fclose(f);
}

}  // namespace ptnpy
