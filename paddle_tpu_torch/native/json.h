// Minimal JSON parser for the serialized Program (__model__) format.
// Supports the subset emitted by paddle_tpu.core.program.to_dict():
// objects, arrays, strings (with \u escapes), numbers, true/false/null.
#pragma once

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <map>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace ptjson {

class Value;
using ValuePtr = std::shared_ptr<Value>;

class Value {
 public:
  enum Kind { kNull, kBool, kNumber, kString, kArray, kObject };
  Kind kind = kNull;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<ValuePtr> arr;
  std::map<std::string, ValuePtr> obj;

  bool is_null() const { return kind == kNull; }
  bool as_bool() const { return b; }
  double as_num() const { return num; }
  int64_t as_int() const { return static_cast<int64_t>(llround(num)); }
  const std::string& as_str() const { return str; }

  const ValuePtr& at(const std::string& key) const {
    auto it = obj.find(key);
    if (it == obj.end()) throw std::runtime_error("missing key: " + key);
    return it->second;
  }
  ValuePtr get(const std::string& key) const {
    auto it = obj.find(key);
    return it == obj.end() ? nullptr : it->second;
  }
  bool has(const std::string& key) const { return obj.count(key) > 0; }
};

class Parser {
 public:
  explicit Parser(const std::string& text) : s_(text) {}

  ValuePtr Parse() {
    ValuePtr v = ParseValue();
    SkipWs();
    if (pos_ != s_.size()) throw std::runtime_error("trailing JSON garbage");
    return v;
  }

 private:
  void SkipWs() {
    while (pos_ < s_.size() &&
           (s_[pos_] == ' ' || s_[pos_] == '\t' || s_[pos_] == '\n' ||
            s_[pos_] == '\r'))
      pos_++;
  }

  char Peek() {
    SkipWs();
    if (pos_ >= s_.size()) throw std::runtime_error("unexpected JSON EOF");
    return s_[pos_];
  }

  void Expect(char c) {
    if (Peek() != c)
      throw std::runtime_error(std::string("expected '") + c + "'");
    pos_++;
  }

  ValuePtr ParseValue() {
    char c = Peek();
    switch (c) {
      case '{':
        return ParseObject();
      case '[':
        return ParseArray();
      case '"':
        return ParseString();
      case 't':
      case 'f':
        return ParseBool();
      case 'n':
        return ParseNull();
      default:
        return ParseNumber();
    }
  }

  ValuePtr ParseObject() {
    auto v = std::make_shared<Value>();
    v->kind = Value::kObject;
    Expect('{');
    if (Peek() == '}') {
      pos_++;
      return v;
    }
    for (;;) {
      ValuePtr key = ParseString();
      Expect(':');
      v->obj[key->str] = ParseValue();
      char c = Peek();
      pos_++;
      if (c == '}') return v;
      if (c != ',') throw std::runtime_error("bad object separator");
    }
  }

  ValuePtr ParseArray() {
    auto v = std::make_shared<Value>();
    v->kind = Value::kArray;
    Expect('[');
    if (Peek() == ']') {
      pos_++;
      return v;
    }
    for (;;) {
      v->arr.push_back(ParseValue());
      char c = Peek();
      pos_++;
      if (c == ']') return v;
      if (c != ',') throw std::runtime_error("bad array separator");
    }
  }

  ValuePtr ParseString() {
    auto v = std::make_shared<Value>();
    v->kind = Value::kString;
    Expect('"');
    while (pos_ < s_.size() && s_[pos_] != '"') {
      char c = s_[pos_++];
      if (c == '\\') {
        if (pos_ >= s_.size()) throw std::runtime_error("bad escape");
        char e = s_[pos_++];
        switch (e) {
          case 'n': v->str += '\n'; break;
          case 't': v->str += '\t'; break;
          case 'r': v->str += '\r'; break;
          case 'b': v->str += '\b'; break;
          case 'f': v->str += '\f'; break;
          case '/': v->str += '/'; break;
          case '\\': v->str += '\\'; break;
          case '"': v->str += '"'; break;
          case 'u': {
            if (pos_ + 4 > s_.size()) throw std::runtime_error("bad \\u");
            unsigned cp = std::stoul(s_.substr(pos_, 4), nullptr, 16);
            pos_ += 4;
            // UTF-8 encode (BMP only; our var names are ASCII anyway)
            if (cp < 0x80) {
              v->str += static_cast<char>(cp);
            } else if (cp < 0x800) {
              v->str += static_cast<char>(0xC0 | (cp >> 6));
              v->str += static_cast<char>(0x80 | (cp & 0x3F));
            } else {
              v->str += static_cast<char>(0xE0 | (cp >> 12));
              v->str += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
              v->str += static_cast<char>(0x80 | (cp & 0x3F));
            }
            break;
          }
          default:
            throw std::runtime_error("bad escape char");
        }
      } else {
        v->str += c;
      }
    }
    if (pos_ >= s_.size()) throw std::runtime_error("unterminated string");
    pos_++;  // closing quote
    return v;
  }

  ValuePtr ParseBool() {
    auto v = std::make_shared<Value>();
    v->kind = Value::kBool;
    if (s_.compare(pos_, 4, "true") == 0) {
      v->b = true;
      pos_ += 4;
    } else if (s_.compare(pos_, 5, "false") == 0) {
      v->b = false;
      pos_ += 5;
    } else {
      throw std::runtime_error("bad literal");
    }
    return v;
  }

  ValuePtr ParseNull() {
    if (s_.compare(pos_, 4, "null") != 0)
      throw std::runtime_error("bad literal");
    pos_ += 4;
    return std::make_shared<Value>();
  }

  ValuePtr ParseNumber() {
    auto v = std::make_shared<Value>();
    v->kind = Value::kNumber;
    const char* start = s_.c_str() + pos_;
    char* end = nullptr;
    v->num = strtod(start, &end);  // zero-copy: substr here would be O(n^2)
    if (end == start) throw std::runtime_error("bad number");
    pos_ += end - start;
    return v;
  }

  const std::string& s_;
  size_t pos_ = 0;
};

inline ValuePtr Parse(const std::string& text) { return Parser(text).Parse(); }

}  // namespace ptjson
