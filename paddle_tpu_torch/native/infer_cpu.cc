// C++ CPU inference executor over the exported inference model.
//
// Parity targets in the reference:
//   - paddle/fluid/inference/io.h:35 `Load(executor, scope, dirname)`:
//     read `__model__` + persistables, then Executor::Run with feed/fetch.
//   - paddle/capi: the embeddable C inference API (capi.h,
//     gradient_machine.h) for server/mobile deploys without Python.
//
// This runner consumes the same artifacts paddle_tpu.io.save_inference_model
// writes (JSON `__model__` + one .npy per persistable var) and executes the
// op list directly in C++ — no Python, no JAX.  The TPU path for native
// deployment is pjrt_runner.cc (PJRT C API); this CPU twin serves the
// capi-style embed case and doubles as the oracle for it in tests.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <functional>
#include <map>
#include <memory>
#include <set>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

#include "json.h"
#include "npy.h"

namespace {

using ptnpy::Array;
using ptnpy::DType;

// Two-level environment: op outputs land in `locals`; reads fall back to the
// read-only param store — params stay pristine with zero per-run copies.
struct Env {
  std::map<std::string, Array> locals;
  const std::map<std::string, Array>* params = nullptr;

  const Array& at(const std::string& name) const {
    auto it = locals.find(name);
    if (it != locals.end()) return it->second;
    if (params) {
      auto pit = params->find(name);
      if (pit != params->end()) return pit->second;
    }
    throw std::runtime_error("variable not found: " + name);
  }
  Array& operator[](const std::string& name) { return locals[name]; }
  bool has(const std::string& name) const {
    return locals.count(name) || (params && params->count(name));
  }
};

struct OpDesc {
  std::string type;
  std::map<std::string, std::vector<std::string>> inputs, outputs;
  ptjson::ValuePtr attrs;

  const std::vector<std::string>& ins(const std::string& slot) const {
    static const std::vector<std::string> empty;
    auto it = inputs.find(slot);
    return it == inputs.end() ? empty : it->second;
  }
  const std::vector<std::string>& outs(const std::string& slot) const {
    static const std::vector<std::string> empty;
    auto it = outputs.find(slot);
    return it == outputs.end() ? empty : it->second;
  }
  std::string in(const std::string& slot) const {
    const auto& v = ins(slot);
    return v.empty() ? "" : v[0];
  }
  std::string out(const std::string& slot) const {
    const auto& v = outs(slot);
    return v.empty() ? "" : v[0];
  }
  double attr_num(const std::string& k, double dflt) const {
    auto v = attrs->get(k);
    return v && v->kind == ptjson::Value::kNumber ? v->num : dflt;
  }
  bool attr_bool(const std::string& k, bool dflt) const {
    auto v = attrs->get(k);
    if (!v) return dflt;
    if (v->kind == ptjson::Value::kBool) return v->b;
    if (v->kind == ptjson::Value::kNumber) return v->num != 0;
    return dflt;
  }
  std::string attr_str(const std::string& k, const std::string& dflt) const {
    auto v = attrs->get(k);
    return v && v->kind == ptjson::Value::kString ? v->str : dflt;
  }
  std::vector<int64_t> attr_ints(const std::string& k,
                                 std::vector<int64_t> dflt = {}) const {
    auto v = attrs->get(k);
    if (!v) return dflt;
    if (v->kind == ptjson::Value::kNumber) return {v->as_int()};
    if (v->kind != ptjson::Value::kArray) return dflt;
    std::vector<int64_t> out;
    for (auto& e : v->arr) out.push_back(e->as_int());
    return out;
  }
};

size_t numel(const std::vector<int64_t>& shape) {
  size_t n = 1;
  for (auto d : shape) n *= static_cast<size_t>(d);
  return n;
}

Array make_f32(std::vector<int64_t> shape) {
  Array a;
  a.dtype = DType::F32;
  a.shape = std::move(shape);
  a.data.resize(a.numel() * 4);
  return a;
}

// Any-int tensor -> flat int64 view (feeds may arrive i32 or i64).
std::vector<int64_t> as_i64(const Array& a) {
  std::vector<int64_t> out(a.numel());
  if (a.dtype == DType::I64) {
    memcpy(out.data(), a.data.data(), out.size() * 8);
  } else if (a.dtype == DType::I32) {
    for (size_t i = 0; i < out.size(); i++) out[i] = a.i32()[i];
  } else {
    throw std::runtime_error("expected integer tensor");
  }
  return out;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Cache-blocked sgemm: C[m,n] += A[m,k] * B[k,n]
void sgemm(const float* A, const float* B, float* C, int64_t M, int64_t K,
           int64_t N) {
  constexpr int64_t BM = 64, BK = 64, BN = 256;
  std::fill(C, C + M * N, 0.f);
  for (int64_t k0 = 0; k0 < K; k0 += BK)
    for (int64_t m0 = 0; m0 < M; m0 += BM)
      for (int64_t n0 = 0; n0 < N; n0 += BN) {
        int64_t kmax = std::min(k0 + BK, K), mmax = std::min(m0 + BM, M),
                nmax = std::min(n0 + BN, N);
        for (int64_t m = m0; m < mmax; m++)
          for (int64_t k = k0; k < kmax; k++) {
            float a = A[m * K + k];
            const float* b = B + k * N;
            float* c = C + m * N;
            for (int64_t n = n0; n < nmax; n++) c[n] += a * b[n];
          }
      }
}

void op_mul(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));
  const Array& y = env.at(op.in("Y"));
  int64_t xnd = op.attr_num("x_num_col_dims", 1);
  int64_t ynd = op.attr_num("y_num_col_dims", 1);
  int64_t M = 1, K = 1, K2 = 1, N = 1;
  for (int64_t i = 0; i < xnd; i++) M *= x.shape[i];
  for (size_t i = xnd; i < x.shape.size(); i++) K *= x.shape[i];
  for (int64_t i = 0; i < ynd; i++) K2 *= y.shape[i];
  for (size_t i = ynd; i < y.shape.size(); i++) N *= y.shape[i];
  if (K != K2) throw std::runtime_error("mul: inner dim mismatch");
  std::vector<int64_t> out_shape(x.shape.begin(), x.shape.begin() + xnd);
  out_shape.insert(out_shape.end(), y.shape.begin() + ynd, y.shape.end());
  Array out = make_f32(out_shape);
  sgemm(x.f32(), y.f32(), out.f32(), M, K, N);
  env[op.out("Out")] = std::move(out);
}

void op_matmul(const OpDesc& op, Env& env) {
  Array x = env.at(op.in("X"));
  Array y = env.at(op.in("Y"));
  bool tx = op.attr_bool("transpose_X", false);
  bool ty = op.attr_bool("transpose_Y", false);
  float alpha = op.attr_num("alpha", 1.0);
  if (x.shape.size() != 2 || y.shape.size() != 2)
    throw std::runtime_error("matmul: only 2D supported in CPU runner");
  auto transpose2d = [](const Array& a) {
    Array t = make_f32({a.shape[1], a.shape[0]});
    for (int64_t i = 0; i < a.shape[0]; i++)
      for (int64_t j = 0; j < a.shape[1]; j++)
        t.f32()[j * a.shape[0] + i] = a.f32()[i * a.shape[1] + j];
    return t;
  };
  if (tx) x = transpose2d(x);
  if (ty) y = transpose2d(y);
  if (x.shape[1] != y.shape[0]) throw std::runtime_error("matmul dims");
  Array out = make_f32({x.shape[0], y.shape[1]});
  sgemm(x.f32(), y.f32(), out.f32(), x.shape[0], x.shape[1], y.shape[1]);
  if (alpha != 1.0f)
    for (size_t i = 0; i < out.numel(); i++) out.f32()[i] *= alpha;
  env[op.out("Out")] = std::move(out);
}

// Elementwise with the reference's axis-alignment (elementwise_op_function.h):
// y's dims align to x's starting at `axis` (axis==-1 -> trailing).
void op_elementwise(const OpDesc& op, Env& env,
                    const std::function<float(float, float)>& fn) {
  const Array& x = env.at(op.in("X"));
  const Array& y = env.at(op.in("Y"));
  int64_t axis = op.attr_num("axis", -1);
  Array out = make_f32(x.shape);
  if (x.shape == y.shape) {
    for (size_t i = 0; i < x.numel(); i++)
      out.f32()[i] = fn(x.f32()[i], y.f32()[i]);
  } else {
    int64_t xnd = x.shape.size(), ynd = y.shape.size();
    if (xnd == ynd) {
      // numpy-style same-rank broadcast (either side may have 1-dims):
      // the attention pattern [B,T,D] * [B,T,1]
      std::vector<int64_t> oshape(xnd);
      for (int64_t i = 0; i < xnd; i++) {
        if (x.shape[i] != y.shape[i] && x.shape[i] != 1 && y.shape[i] != 1)
          throw std::runtime_error("elementwise: broadcast mismatch");
        oshape[i] = std::max(x.shape[i], y.shape[i]);
      }
      out = make_f32(oshape);
      std::vector<int64_t> xs(xnd, 1), ys(xnd, 1), os(xnd, 1);
      for (int64_t i = xnd - 2; i >= 0; i--) {
        xs[i] = xs[i + 1] * x.shape[i + 1];
        ys[i] = ys[i + 1] * y.shape[i + 1];
        os[i] = os[i + 1] * oshape[i + 1];
      }
      std::vector<int64_t> idx(xnd, 0);
      for (size_t flat = 0; flat < out.numel(); flat++) {
        int64_t rem = flat, xi = 0, yi = 0;
        for (int64_t i = 0; i < xnd; i++) {
          idx[i] = rem / os[i];
          rem %= os[i];
          xi += (x.shape[i] == 1 ? 0 : idx[i]) * xs[i];
          yi += (y.shape[i] == 1 ? 0 : idx[i]) * ys[i];
        }
        out.f32()[flat] = fn(x.f32()[xi], y.f32()[yi]);
      }
      env[op.out("Out")] = std::move(out);
      return;
    }
    if (axis < 0) axis = xnd - ynd;
    // x viewed as [pre, mid, post]; y broadcast over pre/post
    int64_t pre = 1, mid = 1, post = 1;
    for (int64_t i = 0; i < axis; i++) pre *= x.shape[i];
    for (int64_t i = axis; i < axis + ynd; i++) mid *= x.shape[i];
    for (int64_t i = axis + ynd; i < xnd; i++) post *= x.shape[i];
    if (mid != static_cast<int64_t>(y.numel()))
      throw std::runtime_error("elementwise: broadcast mismatch");
    for (int64_t p = 0; p < pre; p++)
      for (int64_t m = 0; m < mid; m++) {
        float yv = y.f32()[m];
        const float* xs = x.f32() + (p * mid + m) * post;
        float* os = out.f32() + (p * mid + m) * post;
        for (int64_t q = 0; q < post; q++) os[q] = fn(xs[q], yv);
      }
  }
  env[op.out("Out")] = std::move(out);
}

void op_activation(const OpDesc& op, Env& env,
                   const std::function<float(float)>& fn) {
  const Array& x = env.at(op.ins("X").empty() ? op.in("Input") : op.in("X"));
  Array out = make_f32(x.shape);
  for (size_t i = 0; i < x.numel(); i++) out.f32()[i] = fn(x.f32()[i]);
  env[op.out("Out")] = std::move(out);
}

void op_softmax(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));
  Array out = make_f32(x.shape);
  int64_t cols = x.shape.back();
  int64_t rows = x.numel() / cols;
  for (int64_t r = 0; r < rows; r++) {
    const float* in = x.f32() + r * cols;
    float* o = out.f32() + r * cols;
    float mx = *std::max_element(in, in + cols);
    float sum = 0;
    for (int64_t c = 0; c < cols; c++) {
      o[c] = std::exp(in[c] - mx);
      sum += o[c];
    }
    for (int64_t c = 0; c < cols; c++) o[c] /= sum;
  }
  env[op.out("Out")] = std::move(out);
}

void op_batch_norm(const OpDesc& op, Env& env) {
  // Inference only: y = scale * (x - mean) / sqrt(var + eps) + bias
  if (!op.attr_bool("is_test", false))
    throw std::runtime_error("batch_norm: CPU runner is inference-only");
  const Array& x = env.at(op.in("X"));
  const Array& scale = env.at(op.in("Scale"));
  const Array& bias = env.at(op.in("Bias"));
  const Array& mean = env.at(op.in("Mean"));
  const Array& var = env.at(op.in("Variance"));
  float eps = op.attr_num("epsilon", 1e-5);
  int64_t C = x.shape.size() > 1 ? x.shape[1] : x.shape[0];
  int64_t N = x.shape.size() > 1 ? x.shape[0] : 1;
  int64_t spatial = x.numel() / (N * C);
  Array out = make_f32(x.shape);
  std::vector<float> a(C), b(C);
  for (int64_t c = 0; c < C; c++) {
    float inv = 1.0f / std::sqrt(var.f32()[c] + eps);
    a[c] = scale.f32()[c] * inv;
    b[c] = bias.f32()[c] - mean.f32()[c] * a[c];
  }
  // fused activation (layers/nn.py batch_norm folds relu into the op)
  bool relu = op.attr_str("act", "") == "relu";
  for (int64_t n = 0; n < N; n++)
    for (int64_t c = 0; c < C; c++) {
      const float* xs = x.f32() + (n * C + c) * spatial;
      float* os = out.f32() + (n * C + c) * spatial;
      for (int64_t s = 0; s < spatial; s++) {
        float v = a[c] * xs[s] + b[c];
        os[s] = relu && v < 0.0f ? 0.0f : v;
      }
    }
  env[op.out("Y")] = std::move(out);
}

// conv2d NCHW/OIHW via im2col + grouped gemm (operators/math/im2col parity).
void op_conv2d(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("Input"));
  const Array& w = env.at(op.in("Filter"));
  auto strides = op.attr_ints("strides", {1, 1});
  auto pads = op.attr_ints("paddings", {0, 0});
  auto dils = op.attr_ints("dilations", {1, 1});
  int64_t groups = std::max<int64_t>(1, op.attr_num("groups", 1));
  if (strides.size() == 1) strides = {strides[0], strides[0]};
  if (pads.size() == 1) pads = {pads[0], pads[0]};
  if (dils.size() == 1) dils = {dils[0], dils[0]};
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  int64_t O = w.shape[0], Cg = w.shape[1], KH = w.shape[2], KW = w.shape[3];
  int64_t OH = (H + 2 * pads[0] - (dils[0] * (KH - 1) + 1)) / strides[0] + 1;
  int64_t OW = (W + 2 * pads[1] - (dils[1] * (KW - 1) + 1)) / strides[1] + 1;
  int64_t Og = O / groups;
  Array out = make_f32({N, O, OH, OW});
  std::vector<float> col(Cg * KH * KW * OH * OW);
  for (int64_t n = 0; n < N; n++) {
    for (int64_t g = 0; g < groups; g++) {
      // im2col for this image+group
      const float* img = x.f32() + (n * C + g * Cg) * H * W;
      for (int64_t c = 0; c < Cg; c++)
        for (int64_t kh = 0; kh < KH; kh++)
          for (int64_t kw = 0; kw < KW; kw++) {
            float* dst =
                col.data() + ((c * KH + kh) * KW + kw) * OH * OW;
            for (int64_t oh = 0; oh < OH; oh++) {
              int64_t ih = oh * strides[0] - pads[0] + kh * dils[0];
              if (ih < 0 || ih >= H) {
                std::fill(dst + oh * OW, dst + (oh + 1) * OW, 0.f);
                continue;
              }
              const float* src = img + c * H * W + ih * W;
              for (int64_t ow = 0; ow < OW; ow++) {
                int64_t iw = ow * strides[1] - pads[1] + kw * dils[1];
                dst[oh * OW + ow] =
                    (iw < 0 || iw >= W) ? 0.f : src[iw];
              }
            }
          }
      // gemm: [Og, Cg*KH*KW] x [Cg*KH*KW, OH*OW]
      sgemm(w.f32() + g * Og * Cg * KH * KW, col.data(),
            out.f32() + (n * O + g * Og) * OH * OW, Og, Cg * KH * KW,
            OH * OW);
    }
  }
  env[op.out("Output")] = std::move(out);
}

void op_pool2d(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));
  std::string ptype = op.attr_str("pooling_type", "max");
  auto ksize = op.attr_ints("ksize");
  auto strides = op.attr_ints("strides", {1, 1});
  auto pads = op.attr_ints("paddings", {0, 0});
  bool exclusive = op.attr_bool("exclusive", true);
  if (ksize.size() == 1) ksize = {ksize[0], ksize[0]};
  if (strides.size() == 1) strides = {strides[0], strides[0]};
  if (pads.size() == 1) pads = {pads[0], pads[0]};
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  if (op.attr_bool("global_pooling", false)) {
    ksize = {H, W};
    strides = {1, 1};
    pads = {0, 0};
  }
  int64_t OH = (H + 2 * pads[0] - ksize[0]) / strides[0] + 1;
  int64_t OW = (W + 2 * pads[1] - ksize[1]) / strides[1] + 1;
  Array out = make_f32({N, C, OH, OW});
  bool is_max = ptype == "max";
  for (int64_t nc = 0; nc < N * C; nc++) {
    const float* img = x.f32() + nc * H * W;
    float* o = out.f32() + nc * OH * OW;
    for (int64_t oh = 0; oh < OH; oh++)
      for (int64_t ow = 0; ow < OW; ow++) {
        float acc = is_max ? -INFINITY : 0.f;
        int64_t count = 0;
        for (int64_t kh = 0; kh < ksize[0]; kh++)
          for (int64_t kw = 0; kw < ksize[1]; kw++) {
            int64_t ih = oh * strides[0] - pads[0] + kh;
            int64_t iw = ow * strides[1] - pads[1] + kw;
            if (ih < 0 || ih >= H || iw < 0 || iw >= W) continue;
            float v = img[ih * W + iw];
            if (is_max)
              acc = std::max(acc, v);
            else
              acc += v;
            count++;
          }
        if (is_max)
          o[oh * OW + ow] = acc;
        else
          o[oh * OW + ow] =
              acc / (exclusive ? std::max<int64_t>(count, 1)
                               : ksize[0] * ksize[1]);
      }
  }
  env[op.out("Out")] = std::move(out);
}

void op_reshape(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));
  auto shape = op.attr_ints("shape");
  int64_t known = 1, infer_at = -1;
  for (size_t i = 0; i < shape.size(); i++) {
    if (shape[i] == 0) shape[i] = x.shape[i];
    if (shape[i] == -1)
      infer_at = i;
    else
      known *= shape[i];
  }
  if (infer_at >= 0) shape[infer_at] = x.numel() / known;
  Array out = x;
  out.shape = shape;
  env[op.out("Out")] = std::move(out);
}

void op_lookup_table(const OpDesc& op, Env& env) {
  const Array& w = env.at(op.in("W"));
  const Array& ids_arr = env.at(op.in("Ids"));
  auto ids = as_i64(ids_arr);
  int64_t rows = w.shape[0], dim = w.shape[1];
  std::vector<int64_t> out_shape(ids_arr.shape);
  // trailing [..,1] ids squeeze to [..] + [dim]  (lookup_table_op.cc)
  if (!out_shape.empty() && out_shape.back() == 1) out_shape.pop_back();
  out_shape.push_back(dim);
  Array out = make_f32(out_shape);
  int64_t padding_idx = op.attr_num("padding_idx", -1);
  for (size_t i = 0; i < ids.size(); i++) {
    float* dst = out.f32() + i * dim;
    if (ids[i] == padding_idx) {
      std::fill(dst, dst + dim, 0.f);
    } else {
      // feeds are untrusted runtime input (lookup_table_op.cc enforces range)
      if (ids[i] < 0 || ids[i] >= rows)
        throw std::runtime_error("lookup_table: id out of range");
      memcpy(dst, w.f32() + ids[i] * dim, dim * 4);
    }
  }
  env[op.out("Out")] = std::move(out);
}

void op_concat(const OpDesc& op, Env& env) {
  const auto& names = op.ins("X");
  int64_t axis = op.attr_num("axis", 0);
  const Array& first = env.at(names[0]);
  if (axis < 0) axis += first.shape.size();
  std::vector<int64_t> out_shape = first.shape;
  int64_t cat = 0;
  for (const auto& n : names) cat += env.at(n).shape[axis];
  out_shape[axis] = cat;
  // dtype-size-aware copy: int64 id streams concat too, not just f32
  const size_t esz = ptnpy::dtype_size(first.dtype);
  Array out;
  out.dtype = first.dtype;
  out.shape = out_shape;
  out.data.resize(out.numel() * esz);
  int64_t outer = 1, inner = 1;
  for (int64_t i = 0; i < axis; i++) outer *= out_shape[i];
  for (size_t i = axis + 1; i < out_shape.size(); i++) inner *= out_shape[i];
  int64_t off = 0;
  for (const auto& n : names) {
    const Array& a = env.at(n);
    if (a.dtype != first.dtype)
      throw std::runtime_error("concat: mixed dtypes");
    int64_t mid = a.shape[axis];
    for (int64_t o = 0; o < outer; o++)
      memcpy(out.data.data() + (o * cat + off) * inner * esz,
             a.data.data() + o * mid * inner * esz, mid * inner * esz);
    off += mid;
  }
  env[op.out("Out")] = std::move(out);
}

void op_reduce_mean(const OpDesc& op, Env& env, bool is_mean_op) {
  const Array& x = env.at(op.in("X"));
  if (is_mean_op || op.attr_bool("reduce_all", false)) {
    double sum = 0;
    for (size_t i = 0; i < x.numel(); i++) sum += x.f32()[i];
    Array out = make_f32({1});
    out.f32()[0] = static_cast<float>(sum / x.numel());
    env[op.out("Out")] = std::move(out);
    return;
  }
  // dim-wise mean (reduce_mean attrs "dim" + keep_dim)
  auto dims = op.attr_ints("dim");
  int64_t nd = x.shape.size();
  std::vector<bool> red(nd, false);
  for (auto d : dims) red[(d + nd) % nd] = true;
  bool keep = op.attr_bool("keep_dim", false);
  std::vector<int64_t> oshape;
  for (int64_t i = 0; i < nd; i++) {
    if (!red[i]) oshape.push_back(x.shape[i]);
    else if (keep) oshape.push_back(1);
  }
  if (oshape.empty()) oshape.push_back(1);
  Array out = make_f32(oshape);
  // accumulate in double like the reduce_all branch: this runner is the
  // oracle, and long-axis f32 sums lose mantissa bits
  std::vector<double> acc(out.numel(), 0.0);
  std::vector<int64_t> strides(nd, 1);
  for (int64_t i = nd - 2; i >= 0; i--)
    strides[i] = strides[i + 1] * x.shape[i + 1];
  int64_t red_n = 1;
  for (int64_t i = 0; i < nd; i++) if (red[i]) red_n *= x.shape[i];
  std::vector<int64_t> idx(nd, 0);
  for (size_t flat = 0; flat < x.numel(); flat++) {
    int64_t rem = flat, oflat = 0;
    for (int64_t i = 0; i < nd; i++) {
      idx[i] = rem / strides[i];
      rem %= strides[i];
    }
    int64_t mul = 1;
    for (int64_t i = nd - 1; i >= 0; i--) {
      if (!red[i]) { oflat += idx[i] * mul; mul *= x.shape[i]; }
    }
    acc[oflat] += x.f32()[flat];
  }
  for (size_t i = 0; i < out.numel(); i++)
    out.f32()[i] = static_cast<float>(acc[i] / red_n);
  env[op.out("Out")] = std::move(out);
}

void op_transpose(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));
  auto axis = op.attr_ints("axis");
  int64_t nd = x.shape.size();
  std::vector<int64_t> out_shape(nd), strides(nd, 1), out_strides(nd, 1);
  for (int64_t i = nd - 2; i >= 0; i--)
    strides[i] = strides[i + 1] * x.shape[i + 1];
  for (int64_t i = 0; i < nd; i++) out_shape[i] = x.shape[axis[i]];
  for (int64_t i = nd - 2; i >= 0; i--)
    out_strides[i] = out_strides[i + 1] * out_shape[i + 1];
  Array out = make_f32(out_shape);
  std::vector<int64_t> idx(nd, 0);
  for (size_t flat = 0; flat < x.numel(); flat++) {
    int64_t rem = flat, src = 0;
    for (int64_t i = 0; i < nd; i++) {
      idx[i] = rem / out_strides[i];
      rem %= out_strides[i];
      src += idx[i] * strides[axis[i]];
    }
    out.f32()[flat] = x.f32()[src];
  }
  env[op.out("Out")] = std::move(out);
}


// ---------------------------------------------------------------------------
// Sequence / recurrent ops (the seq2seq book-model inference set)
// ---------------------------------------------------------------------------

// Optional ragged-length companion (the LoD analog): "<name>@SEQ_LEN".
const Array* seq_len_of(const Env& env, const std::string& name) {
  std::string key = name + "@SEQ_LEN";
  return env.has(key) ? &env.at(key) : nullptr;
}

int64_t row_len(const Array* lens, int64_t b, int64_t T) {
  if (!lens) return T;
  if (lens->dtype == DType::I32) return lens->i32()[b];
  return reinterpret_cast<const int64_t*>(lens->data.data())[b];
}

void op_sum(const OpDesc& op, Env& env) {
  const auto& names = op.ins("X");
  const Array& first = env.at(names.at(0));
  Array out = make_f32(first.shape);
  memcpy(out.data.data(), first.data.data(), first.numel() * 4);
  for (size_t k = 1; k < names.size(); k++) {
    const Array& a = env.at(names[k]);
    if (a.shape != first.shape)
      throw std::runtime_error("sum: shape mismatch");
    for (size_t i = 0; i < out.numel(); i++) out.f32()[i] += a.f32()[i];
  }
  env[op.out("Out")] = std::move(out);
}

void op_fill_constant_batch_size_like(const OpDesc& op, Env& env) {
  const Array& ref = env.at(op.in("Input"));
  auto shape = op.attr_ints("shape");
  int64_t in_idx = op.attr_num("input_dim_idx", 0);
  int64_t out_idx = op.attr_num("output_dim_idx", 0);
  shape[out_idx] = ref.shape[in_idx];
  Array out = make_f32(shape);
  float v = static_cast<float>(op.attr_num("value", 0.0));
  for (size_t i = 0; i < out.numel(); i++) out.f32()[i] = v;
  env[op.out("Out")] = std::move(out);
}

// Dynamic LSTM over padded [B, T, 4H] gate inputs (lstm_op.cc; gate order
// i, f, g, o; standard activations — matches ops/sequence_ops.py).
void op_lstm(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("Input"));
  const Array& w = env.at(op.in("Weight"));        // [H, 4H]
  const Array* bias = op.in("Bias").empty() ? nullptr : &env.at(op.in("Bias"));
  bool reverse = op.attr_bool("is_reverse", false);
  const Array* lens = seq_len_of(env, op.in("Input"));
  int64_t B = x.shape[0], T = x.shape[1], H4 = x.shape[2], H = H4 / 4;
  Array hid = make_f32({B, T, H}), cell = make_f32({B, T, H});
  std::vector<float> h(B * H, 0.f), c(B * H, 0.f), gates(H4);
  auto sig = [](float v) { return 1.f / (1.f + std::exp(-v)); };
  for (int64_t b = 0; b < B; b++) {
    int64_t L = row_len(lens, b, T);
    std::fill(h.begin() + b * H, h.begin() + (b + 1) * H, 0.f);
    std::fill(c.begin() + b * H, c.begin() + (b + 1) * H, 0.f);
    for (int64_t step = 0; step < T; step++) {
      int64_t t = reverse ? T - 1 - step : step;
      // padding rows hold state (mask semantics)
      bool alive = reverse ? (t < L) : (step < L);
      float* hrow = h.data() + b * H;
      float* crow = c.data() + b * H;
      if (alive) {
        const float* xt = x.f32() + (b * T + t) * H4;
        for (int64_t j = 0; j < H4; j++) {
          float acc = xt[j] + (bias ? bias->f32()[j] : 0.f);
          for (int64_t i = 0; i < H; i++) acc += hrow[i] * w.f32()[i * H4 + j];
          gates[j] = acc;
        }
        for (int64_t i = 0; i < H; i++) {
          float ig = sig(gates[i]);
          float fg = sig(gates[H + i]);
          float gg = std::tanh(gates[2 * H + i]);
          float og = sig(gates[3 * H + i]);
          crow[i] = fg * crow[i] + ig * gg;
          hrow[i] = og * std::tanh(crow[i]);
        }
      }
      memcpy(hid.f32() + (b * T + t) * H, hrow, H * 4);
      memcpy(cell.f32() + (b * T + t) * H, crow, H * 4);
    }
  }
  if (lens) {
    Array lcopy = env.at(op.in("Input") + "@SEQ_LEN");
    env[op.out("Hidden") + "@SEQ_LEN"] = lcopy;
  }
  env[op.out("Hidden")] = std::move(hid);
  if (!op.out("Cell").empty()) env[op.out("Cell")] = std::move(cell);
}

void op_sequence_pool(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));             // [B, T, ...]
  std::string ptype = op.attr_str("pooltype", "AVERAGE");
  const Array* lens = seq_len_of(env, op.in("X"));
  int64_t B = x.shape[0], T = x.shape[1];
  int64_t D = 1;
  for (size_t i = 2; i < x.shape.size(); i++) D *= x.shape[i];
  std::vector<int64_t> oshape{B};
  for (size_t i = 2; i < x.shape.size(); i++) oshape.push_back(x.shape[i]);
  if (oshape.size() == 1) oshape.push_back(1);
  Array out = make_f32(oshape);
  for (int64_t b = 0; b < B; b++) {
    int64_t L = std::max<int64_t>(1, row_len(lens, b, T));
    for (int64_t d = 0; d < D; d++) {
      const float* col = x.f32() + b * T * D + d;
      float v;
      if (ptype == "FIRST") {
        v = col[0];
      } else if (ptype == "LAST") {
        v = col[(L - 1) * D];
      } else if (ptype == "MAX") {
        v = col[0];
        for (int64_t t = 1; t < L; t++) v = std::max(v, col[t * D]);
      } else {  // SUM / AVERAGE / SQRT
        double s = 0;
        for (int64_t t = 0; t < L; t++) s += col[t * D];
        if (ptype == "AVERAGE") s /= L;
        else if (ptype == "SQRT") s /= std::sqrt(static_cast<double>(L));
        v = static_cast<float>(s);
      }
      out.f32()[b * D + d] = v;
    }
  }
  if (oshape.size() == 2 && x.shape.size() == 2) out.shape = {B, 1};
  env[op.out("Out")] = std::move(out);
}

void op_sequence_softmax(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));             // [B, T] or [B, T, 1]
  const Array* lens = seq_len_of(env, op.in("X"));
  int64_t B = x.shape[0], T = x.shape[1];
  Array out = make_f32(x.shape);
  for (int64_t b = 0; b < B; b++) {
    int64_t L = std::max<int64_t>(1, row_len(lens, b, T));
    const float* row = x.f32() + b * T;
    float* orow = out.f32() + b * T;
    float mx = row[0];
    for (int64_t t = 1; t < L; t++) mx = std::max(mx, row[t]);
    double denom = 0;
    for (int64_t t = 0; t < L; t++) denom += std::exp(row[t] - mx);
    for (int64_t t = 0; t < T; t++)
      orow[t] = t < L ? static_cast<float>(std::exp(row[t] - mx) / denom)
                      : 0.f;
  }
  if (lens) env[op.out("Out") + "@SEQ_LEN"] = env.at(op.in("X") + "@SEQ_LEN");
  env[op.out("Out")] = std::move(out);
}

void op_sequence_expand(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));             // [B, D] or [B, 1, D]
  const Array& y = env.at(op.in("Y"));             // [B, T, ...] reference
  int64_t B = x.shape[0], T = y.shape[1];
  int64_t D = x.numel() / B;
  Array out = make_f32({B, T, D});
  for (int64_t b = 0; b < B; b++)
    for (int64_t t = 0; t < T; t++)
      memcpy(out.f32() + (b * T + t) * D, x.f32() + b * D, D * 4);
  const Array* ylens = seq_len_of(env, op.in("Y"));
  if (ylens) env[op.out("Out") + "@SEQ_LEN"] = env.at(op.in("Y") + "@SEQ_LEN");
  env[op.out("Out")] = std::move(out);
}



// Dynamic GRU over padded [B, T, 3H] (gru_op.cc; [:, :2H] reset/update
// via w_rz, [:, 2H:] candidate via w_c; h' = (1-z)h + z c).
void op_gru(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("Input"));
  const Array& w = env.at(op.in("Weight"));          // [H, 3H]
  const Array* bias = op.in("Bias").empty() ? nullptr
                                            : &env.at(op.in("Bias"));
  bool reverse = op.attr_bool("is_reverse", false);
  const Array* lens = seq_len_of(env, op.in("Input"));
  int64_t B = x.shape[0], T = x.shape[1], H3 = x.shape[2], H = H3 / 3;
  Array hid = make_f32({B, T, H});
  std::vector<float> h(H), rz(2 * H), c(H), rh(H);
  auto sig = [](float v) { return 1.f / (1.f + std::exp(-v)); };
  for (int64_t b = 0; b < B; b++) {
    int64_t L = row_len(lens, b, T);
    std::fill(h.begin(), h.end(), 0.f);
    for (int64_t step = 0; step < T; step++) {
      int64_t t = reverse ? T - 1 - step : step;
      bool alive = reverse ? (t < L) : (step < L);
      if (alive) {
        const float* xt = x.f32() + (b * T + t) * H3;
        for (int64_t j = 0; j < 2 * H; j++) {
          float acc = xt[j] + (bias ? bias->f32()[j] : 0.f);
          for (int64_t i = 0; i < H; i++) acc += h[i] * w.f32()[i * H3 + j];
          rz[j] = sig(acc);
        }
        for (int64_t i = 0; i < H; i++) rh[i] = rz[i] * h[i];   // r*h
        for (int64_t j = 0; j < H; j++) {
          float acc = xt[2 * H + j] + (bias ? bias->f32()[2 * H + j] : 0.f);
          for (int64_t i = 0; i < H; i++)
            acc += rh[i] * w.f32()[i * H3 + 2 * H + j];
          c[j] = std::tanh(acc);
        }
        for (int64_t i = 0; i < H; i++) {
          float z = rz[H + i];
          h[i] = (1.f - z) * h[i] + z * c[i];
        }
      }
      memcpy(hid.f32() + (b * T + t) * H, h.data(), H * 4);
    }
  }
  if (lens)
    env[op.out("Hidden") + "@SEQ_LEN"] =
        env.at(op.in("Input") + "@SEQ_LEN");
  env[op.out("Hidden")] = std::move(hid);
}

void op_cos_sim(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));               // [B, D]
  const Array& y = env.at(op.in("Y"));               // [B, D] or [1, D]
  int64_t B = x.shape[0], D = x.shape[1];
  int64_t yB = y.shape[0];
  Array out = make_f32({B, 1});
  for (int64_t b = 0; b < B; b++) {
    const float* xr = x.f32() + b * D;
    const float* yr = y.f32() + (yB == 1 ? 0 : b) * D;
    double dot = 0, nx = 0, ny = 0;
    for (int64_t d = 0; d < D; d++) {
      dot += double(xr[d]) * yr[d];
      nx += double(xr[d]) * xr[d];
      ny += double(yr[d]) * yr[d];
    }
    out.f32()[b] = static_cast<float>(
        dot / (std::sqrt(nx) * std::sqrt(ny) + 1e-12));
  }
  env[op.out("Out")] = std::move(out);
}

void op_sequence_conv(const OpDesc& op, Env& env) {
  const Array& x = env.at(op.in("X"));               // [B, T, D]
  const Array& w = env.at(op.in("Filter"));          // [ctx_len*D, F]
  int64_t ctx_len = op.attr_num("contextLength", 3);
  int64_t ctx_start = op.attr_num("contextStart", -(ctx_len / 2));
  const Array* lens = seq_len_of(env, op.in("X"));
  int64_t B = x.shape[0], T = x.shape[1], D = x.shape[2];
  int64_t F = w.shape[1];
  Array out = make_f32({B, T, F});
  std::vector<float> window(ctx_len * D);
  for (int64_t b = 0; b < B; b++) {
    int64_t L = row_len(lens, b, T);
    for (int64_t t = 0; t < T; t++) {
      if (t >= L) {
        std::fill(out.f32() + (b * T + t) * F,
                  out.f32() + (b * T + t + 1) * F, 0.f);
        continue;
      }
      for (int64_t i = 0; i < ctx_len; i++) {
        int64_t src = t + ctx_start + i;
        if (src < 0 || src >= L)
          std::fill(window.begin() + i * D, window.begin() + (i + 1) * D,
                    0.f);
        else
          memcpy(window.data() + i * D, x.f32() + (b * T + src) * D, D * 4);
      }
      float* orow = out.f32() + (b * T + t) * F;
      for (int64_t f = 0; f < F; f++) {
        double acc = 0;
        for (int64_t c = 0; c < ctx_len * D; c++)
          acc += double(window[c]) * w.f32()[c * F + f];
        orow[f] = static_cast<float>(acc);
      }
    }
  }
  if (lens) env[op.out("Out") + "@SEQ_LEN"] = env.at(op.in("X") + "@SEQ_LEN");
  env[op.out("Out")] = std::move(out);
}

void op_crf_decoding(const OpDesc& op, Env& env) {
  // Viterbi over padded [B, T, C] emissions; Transition rows are
  // [start; end; C x C] (crf_ops.py _crf_pieces layout)
  const Array& em = env.at(op.in("Emission"));
  const Array& tr = env.at(op.in("Transition"));
  const Array* lens = seq_len_of(env, op.in("Emission"));
  int64_t B = em.shape[0], T = em.shape[1], C = em.shape[2];
  const float* start = tr.f32();
  const float* endw = tr.f32() + C;
  const float* trans = tr.f32() + 2 * C;
  Array out;
  out.dtype = DType::I64;
  out.shape = {B, T};
  out.data.resize(B * T * 8);
  int64_t* path = reinterpret_cast<int64_t*>(out.data.data());
  std::vector<double> delta(C), next(C);
  std::vector<int> ptr(T * C);
  for (int64_t b = 0; b < B; b++) {
    int64_t L = std::max<int64_t>(1, row_len(lens, b, T));
    const float* e0 = em.f32() + b * T * C;
    for (int64_t c = 0; c < C; c++) delta[c] = double(start[c]) + e0[c];
    for (int64_t t = 1; t < L; t++) {
      const float* et = e0 + t * C;
      for (int64_t c = 0; c < C; c++) {
        double best = -1e30;
        int arg = 0;
        for (int64_t p = 0; p < C; p++) {
          double s = delta[p] + trans[p * C + c];
          if (s > best) { best = s; arg = int(p); }
        }
        next[c] = best + et[c];
        ptr[t * C + c] = arg;
      }
      delta.swap(next);
    }
    double best = -1e30;
    int64_t cur = 0;
    for (int64_t c = 0; c < C; c++) {
      double s = delta[c] + endw[c];
      if (s > best) { best = s; cur = c; }
    }
    for (int64_t t = L - 1; t >= 0; t--) {
      path[b * T + t] = cur;
      if (t > 0) cur = ptr[t * C + cur];
    }
    for (int64_t t = L; t < T; t++) path[b * T + t] = 0;  // masked tail
  }
  env[op.out("ViterbiPath")] = std::move(out);
}

// ---------------------------------------------------------------------------
// Executor
// ---------------------------------------------------------------------------

struct InferCpu {
  std::vector<OpDesc> ops;            // block 0 (back-compat alias)
  std::vector<std::vector<OpDesc>> blocks;
  std::vector<std::string> feed_names, fetch_names;
  std::map<std::string, Array> params;  // persistables loaded once
  std::map<std::string, Array> staged;  // feeds staged for the next run
  std::vector<Array> last_outputs;
  std::string error;
  bool load_ok = false;
};

using BlockTable = std::vector<std::vector<OpDesc>>;

void run_op(const OpDesc& op, Env& env, const BlockTable& blocks);

// recurrent_group lowering (ops/rnn_ops.py dynamic_rnn): interpret the
// step sub-block T times with named memories; outputs stack over time.
void op_dynamic_rnn(const OpDesc& op, Env& env, const BlockTable& blocks) {
  int64_t sub = op.attr_num("sub_block", 1);
  auto pairs = op.attrs->get("step_inputs");
  auto statics = op.attrs->get("static_inputs");
  auto mems = op.attrs->get("memories");
  auto out_vars = op.attrs->get("output_vars");
  if (!pairs || pairs->arr.empty())
    throw std::runtime_error("dynamic_rnn: no step inputs");

  const Array& x0 = env.at(pairs->arr[0]->arr[0]->as_str());
  int64_t B = x0.shape[0], T = x0.shape[1];
  const Array* lens = seq_len_of(env, pairs->arr[0]->arr[0]->as_str());

  Env step_env;
  step_env.params = env.params;
  // statics are loop-invariant: copy once (incl. their ragged lengths)
  if (statics)
    for (auto& pr : statics->arr) {
      const std::string outer = pr->arr[0]->as_str();
      const std::string inner = pr->arr[1]->as_str();
      step_env[inner] = env.at(outer);
      if (const Array* sl = seq_len_of(env, outer))
        step_env[inner + "@SEQ_LEN"] = *sl;
    }
  // memories: init values
  struct Mem { std::string step, next; Array value; };
  std::vector<Mem> memory;
  if (mems)
    for (auto& m : mems->arr) {
      Mem mm;
      mm.step = m->get("step")->as_str();
      mm.next = m->get("new")->as_str();
      auto init = m->get("init");
      if (init && init->kind == ptjson::Value::kString) {
        mm.value = env.at(init->as_str());
      } else {
        auto shp = m->get("shape");
        std::vector<int64_t> s{B};
        if (shp && shp->kind == ptjson::Value::kArray)
          for (auto& d : shp->arr) s.push_back(d->as_int());
        mm.value = make_f32(s);
      }
      memory.push_back(std::move(mm));
    }

  const auto& out_names = op.outs("Out");
  std::vector<Array> stacked(out_names.size());
  for (int64_t t = 0; t < T; t++) {
    // step inputs: slice [B, t, ...] -> [B, ...]
    for (auto& pr : pairs->arr) {
      const Array& xs = env.at(pr->arr[0]->as_str());
      int64_t D = xs.numel() / (B * T);
      Array xt = make_f32({B, D});
      for (int64_t b = 0; b < B; b++)
        memcpy(xt.f32() + b * D, xs.f32() + (b * T + t) * D, D * 4);
      step_env[pr->arr[1]->as_str()] = std::move(xt);
    }
    for (auto& m : memory) step_env[m.step] = m.value;
    for (const auto& sop : blocks.at(sub)) run_op(sop, step_env, blocks);
    // masked memory update + output stacking (rows past their length hold
    // state and emit zeros, matching the scan lowering)
    for (auto& m : memory) {
      const Array& nv = step_env.at(m.next);
      int64_t D = nv.numel() / B;
      for (int64_t b = 0; b < B; b++)
        if (t < row_len(lens, b, T))
          memcpy(m.value.f32() + b * D, nv.f32() + b * D, D * 4);
    }
    size_t k = 0;
    auto& ovarr = out_vars->arr;
    for (const auto& name : out_names) {
      const Array& o = step_env.at(ovarr.at(k)->as_str());
      int64_t D = o.numel() / B;
      if (t == 0) {
        std::vector<int64_t> s{B, T};
        for (size_t i = 1; i < o.shape.size(); i++) s.push_back(o.shape[i]);
        stacked[k] = make_f32(s);
      }
      for (int64_t b = 0; b < B; b++)
        if (t < row_len(lens, b, T))
          memcpy(stacked[k].f32() + (b * T + t) * D, o.f32() + b * D, D * 4);
      k++;
    }
  }
  for (size_t k = 0; k < out_names.size(); k++)
    env[out_names[k]] = std::move(stacked[k]);
  if (lens)
    env[out_names[0] + "@SEQ_LEN"] =
        env.at(pairs->arr[0]->arr[0]->as_str() + "@SEQ_LEN");
}

void run_op_impl(const OpDesc& op, Env& env, const BlockTable& blocks) {
  const std::string& t = op.type;
  if (t == "feed" || t == "fetch") return;
  if (t == "mul") return op_mul(op, env);
  if (t == "matmul") return op_matmul(op, env);
  if (t == "elementwise_add")
    return op_elementwise(op, env, [](float a, float b) { return a + b; });
  if (t == "elementwise_sub")
    return op_elementwise(op, env, [](float a, float b) { return a - b; });
  if (t == "elementwise_mul")
    return op_elementwise(op, env, [](float a, float b) { return a * b; });
  if (t == "elementwise_div")
    return op_elementwise(op, env, [](float a, float b) { return a / b; });
  if (t == "relu")
    return op_activation(op, env, [](float v) { return v > 0 ? v : 0; });
  if (t == "sigmoid")
    return op_activation(op, env,
                         [](float v) { return 1.f / (1.f + std::exp(-v)); });
  if (t == "tanh")
    return op_activation(op, env, [](float v) { return std::tanh(v); });
  if (t == "sqrt")
    return op_activation(op, env, [](float v) { return std::sqrt(v); });
  if (t == "square")
    return op_activation(op, env, [](float v) { return v * v; });
  if (t == "abs")
    return op_activation(op, env, [](float v) { return std::fabs(v); });
  if (t == "exp")
    return op_activation(op, env, [](float v) { return std::exp(v); });
  if (t == "scale") {
    float s = op.attr_num("scale", 1.0), b = op.attr_num("bias", 0.0);
    bool after = op.attr_bool("bias_after_scale", true);
    return op_activation(op, env, [=](float v) {
      return after ? v * s + b : (v + b) * s;
    });
  }
  if (t == "dropout") {
    if (!op.attr_bool("is_test", false))
      throw std::runtime_error("dropout: CPU runner is inference-only");
    float p = op.attr_num("dropout_prob", 0.5);
    return op_activation(op, env, [=](float v) { return v * (1.f - p); });
  }
  if (t == "softmax") return op_softmax(op, env);
  if (t == "batch_norm") return op_batch_norm(op, env);
  if (t == "conv2d" || t == "depthwise_conv2d") return op_conv2d(op, env);
  if (t == "pool2d") return op_pool2d(op, env);
  if (t == "reshape") return op_reshape(op, env);
  if (t == "lookup_table") return op_lookup_table(op, env);
  if (t == "concat") return op_concat(op, env);
  if (t == "sum" || t == "sums") return op_sum(op, env);
  if (t == "lstm") return op_lstm(op, env);
  if (t == "sequence_pool") return op_sequence_pool(op, env);
  if (t == "sequence_softmax") return op_sequence_softmax(op, env);
  if (t == "sequence_expand") return op_sequence_expand(op, env);
  if (t == "fill_constant_batch_size_like")
    return op_fill_constant_batch_size_like(op, env);
  if (t == "dynamic_rnn") return op_dynamic_rnn(op, env, blocks);
  if (t == "cos_sim") return op_cos_sim(op, env);
  if (t == "gru") return op_gru(op, env);
  if (t == "sequence_conv") return op_sequence_conv(op, env);
  if (t == "crf_decoding") return op_crf_decoding(op, env);
  if (t == "mean") return op_reduce_mean(op, env, true);
  if (t == "reduce_mean") return op_reduce_mean(op, env, false);
  if (t == "transpose") return op_transpose(op, env);
  throw std::runtime_error("unsupported op in CPU runner: " + t);
}

void run_op(const OpDesc& op, Env& env, const BlockTable& blocks) {
  run_op_impl(op, env, blocks);
  // ragged-length propagation (the @SEQ_LEN companion rides along shape-
  // preserving ops exactly as in core/lowering.py)
  static const std::set<std::string> kCarry = {
      "mul", "tanh", "sigmoid", "relu", "scale", "softmax", "dropout",
      "elementwise_add", "elementwise_sub", "elementwise_mul",
      "elementwise_div", "concat", "sum"};
  if (kCarry.count(op.type) || op.type == "lookup_table") {
    std::string in0;
    if (op.type == "lookup_table") in0 = op.in("Ids");
    else if (!op.ins("X").empty()) in0 = op.ins("X")[0];
    else if (!op.ins("Input").empty()) in0 = op.ins("Input")[0];
    std::string out0 = op.out("Out");
    if (!in0.empty() && !out0.empty() && env.has(in0 + "@SEQ_LEN") &&
        !env.has(out0 + "@SEQ_LEN"))
      env[out0 + "@SEQ_LEN"] = env.at(in0 + "@SEQ_LEN");
  }
}

}  // namespace

extern "C" {

InferCpu* infer_cpu_load(const char* model_dir) {
  auto* h = new InferCpu();
  try {
    std::string dir(model_dir);
    std::ifstream f(dir + "/__model__");
    if (!f) throw std::runtime_error("missing __model__ in " + dir);
    std::stringstream ss;
    ss << f.rdbuf();
    auto meta = ptjson::Parse(ss.str());
    for (auto& n : meta->at("feed_names")->arr)
      h->feed_names.push_back(n->as_str());
    for (auto& n : meta->at("fetch_names")->arr)
      h->fetch_names.push_back(n->as_str());
    auto program = meta->at("program");
    auto block0 = program->at("blocks")->arr.at(0);
    for (auto& blockv : program->at("blocks")->arr) {
      std::vector<OpDesc> block_ops;
      for (auto& opv : blockv->at("ops")->arr) {
        OpDesc op;
        op.type = opv->at("type")->as_str();
        for (auto& kv : opv->at("inputs")->obj) {
          for (auto& n : kv.second->arr)
            op.inputs[kv.first].push_back(n->as_str());
        }
        for (auto& kv : opv->at("outputs")->obj) {
          for (auto& n : kv.second->arr)
            op.outputs[kv.first].push_back(n->as_str());
        }
        op.attrs = opv->at("attrs");
        block_ops.push_back(std::move(op));
      }
      h->blocks.push_back(std::move(block_ops));
    }
    h->ops = h->blocks.at(0);
    // load persistables (one .npy per var, save_persistables layout) —
    // sub-blocks (dynamic_rnn steps) declare their own params, so walk
    // every block's var list
    std::vector<std::string> missing;
    std::vector<ptjson::ValuePtr> all_vars;
    for (auto& blockv : program->at("blocks")->arr)
      for (auto& varv : blockv->at("vars")->arr) all_vars.push_back(varv);
    (void)block0;
    for (auto& varv : all_vars) {
      if (!varv->at("persistable")->as_bool()) continue;
      std::string name = varv->at("name")->as_str();
      if (h->params.count(name)) continue;
      std::string path = dir + "/" + name + ".npy";
      std::ifstream probe(path);
      if (!probe) {
        missing.push_back(name);  // ok only if no op reads it
        continue;
      }
      Array a = ptnpy::Load(path);
      if (a.dtype == DType::F64) {  // normalise to f32 for kernels
        Array f = make_f32(a.shape);
        const double* src = reinterpret_cast<const double*>(a.data.data());
        for (size_t i = 0; i < f.numel(); i++) f.f32()[i] = src[i];
        a = std::move(f);
      }
      h->params[name] = std::move(a);
    }
    // a persistable that some op reads but has no .npy means the model was
    // exported with params_filename (single-file blob) — fail loudly now
    // instead of a cryptic miss at run time
    for (const auto& blk : h->blocks)
     for (const auto& op : blk)
      for (const auto& kv : op.inputs)
        for (const auto& in_name : kv.second)
          for (const auto& m : missing)
            if (in_name == m)
              throw std::runtime_error(
                  "param '" + m + "' has no .npy in " + dir +
                  " (export without params_filename for native inference)");
    h->load_ok = true;
  } catch (const std::exception& e) {
    h->error = e.what();
  }
  return h;
}

const char* infer_cpu_error(InferCpu* h) { return h->error.c_str(); }

int64_t infer_cpu_num_feeds(InferCpu* h) { return h->feed_names.size(); }
const char* infer_cpu_feed_name(InferCpu* h, int64_t i) {
  return h->feed_names.at(i).c_str();
}
int64_t infer_cpu_num_fetches(InferCpu* h) { return h->fetch_names.size(); }
const char* infer_cpu_fetch_name(InferCpu* h, int64_t i) {
  return h->fetch_names.at(i).c_str();
}

// Stage one feed tensor for the next run.  dtype: 0=f32 2=i32 3=i64.
int infer_cpu_stage_feed(InferCpu* h, const char* name, int dtype,
                         const int64_t* dims, int64_t ndim,
                         const void* data) {
  try {
    Array a;
    a.dtype = static_cast<DType>(dtype);
    a.shape.assign(dims, dims + ndim);
    a.data.resize(a.numel() * ptnpy::dtype_size(a.dtype));
    memcpy(a.data.data(), data, a.data.size());
    h->staged[name] = std::move(a);
    return 0;
  } catch (const std::exception& e) {
    h->error = e.what();
    return -1;
  }
}

// Runs the program on staged feeds; returns number of fetch outputs, -1 on
// error (see infer_cpu_error).
int64_t infer_cpu_run(InferCpu* h) {
  try {
    if (!h->load_ok) return -1;   // load failure is sticky
    h->error.clear();             // per-run errors are not
    Env env;  // locals + read-only param fallback: zero weight copies per run
    env.params = &h->params;
    for (auto& kv : h->staged) env[kv.first] = std::move(kv.second);
    h->staged.clear();
    for (const auto& op : h->ops) run_op(op, env, h->blocks);
    h->last_outputs.clear();
    for (const auto& n : h->fetch_names) {
      if (!env.has(n))
        throw std::runtime_error("fetch var not produced: " + n);
      auto it = env.locals.find(n);
      if (it != env.locals.end())
        h->last_outputs.push_back(std::move(it->second));
      else
        h->last_outputs.push_back(env.at(n));  // fetched a param: copy
    }
    return h->last_outputs.size();
  } catch (const std::exception& e) {
    h->error = e.what();
    return -1;
  }
}

int64_t infer_cpu_output_ndim(InferCpu* h, int64_t i) {
  return h->last_outputs.at(i).shape.size();
}
void infer_cpu_output_dims(InferCpu* h, int64_t i, int64_t* dims) {
  const auto& s = h->last_outputs.at(i).shape;
  std::copy(s.begin(), s.end(), dims);
}
int infer_cpu_output_dtype(InferCpu* h, int64_t i) {
  return static_cast<int>(h->last_outputs.at(i).dtype);
}
const void* infer_cpu_output_data(InferCpu* h, int64_t i) {
  return h->last_outputs.at(i).data.data();
}

void infer_cpu_destroy(InferCpu* h) { delete h; }

}  // extern "C"
