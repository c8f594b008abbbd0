// C inference API implementation (see paddle_tpu_capi.h).
//
// Thin, allocation-safe layer over the infer_cpu executor (infer_cpu.cc):
// the reference's paddle/capi wraps GradientMachine the same way — opaque
// handles + error codes over the C++ engine (capi/gradient_machine.cpp).
#include "paddle_tpu_capi.h"

#include <cstring>
#include <string>
#include <vector>

#include "npy.h"

// ---- infer_cpu.cc C surface (same shared library) -------------------------
extern "C" {
struct InferCpu;
InferCpu* infer_cpu_load(const char* model_dir);
const char* infer_cpu_error(InferCpu* h);
int64_t infer_cpu_num_feeds(InferCpu* h);
const char* infer_cpu_feed_name(InferCpu* h, int64_t i);
int64_t infer_cpu_num_fetches(InferCpu* h);
const char* infer_cpu_fetch_name(InferCpu* h, int64_t i);
int infer_cpu_stage_feed(InferCpu* h, const char* name, int dtype,
                         const int64_t* dims, int64_t ndim, const void* data);
int64_t infer_cpu_run(InferCpu* h);
int64_t infer_cpu_output_ndim(InferCpu* h, int64_t i);
void infer_cpu_output_dims(InferCpu* h, int64_t i, int64_t* dims);
int infer_cpu_output_dtype(InferCpu* h, int64_t i);
const void* infer_cpu_output_data(InferCpu* h, int64_t i);
void infer_cpu_destroy(InferCpu* h);
}

namespace {
// dtype codes are the npy.h DType codes — one authoritative size table
size_t dtype_size(pt_dtype d) {
  return ptnpy::dtype_size(static_cast<ptnpy::DType>(d));
}
}  // namespace

struct pt_tensor {
  pt_dtype dtype = PT_F32;
  std::vector<int64_t> dims;
  std::vector<uint8_t> owned;     // owning tensors
  const void* borrow = nullptr;   // borrowed views (predictor outputs)

  int64_t numel() const {
    int64_t n = 1;
    for (auto d : dims) n *= d;
    return n;
  }
  const void* data() const { return borrow ? borrow : owned.data(); }
};

struct pt_predictor {
  InferCpu* h = nullptr;
  bool load_ok = false;
  int64_t n_outputs = 0;
  std::vector<pt_tensor> outputs;
  std::string error;
};

extern "C" {

// ---- tensors --------------------------------------------------------------
pt_tensor* pt_tensor_create(pt_dtype dtype, const int64_t* dims,
                            int64_t ndim) {
  if (ndim < 0 || (ndim > 0 && dims == nullptr)) return nullptr;
  if (dtype < PT_F32 || dtype > PT_I64) return nullptr;
  for (int64_t i = 0; i < ndim; i++) {
    if (dims[i] < 0) return nullptr;    // symbolic/negative dims invalid here
  }
  try {
    auto* t = new pt_tensor();
    t->dtype = dtype;
    t->dims.assign(dims, dims + ndim);
    t->owned.resize(static_cast<size_t>(t->numel()) * dtype_size(dtype));
    return t;
  } catch (...) {          // allocation failure must not unwind the C ABI
    return nullptr;
  }
}

void pt_tensor_destroy(pt_tensor* t) { delete t; }

pt_dtype pt_tensor_dtype(const pt_tensor* t) {
  return t ? t->dtype : PT_F32;
}

int64_t pt_tensor_ndim(const pt_tensor* t) {
  return t ? static_cast<int64_t>(t->dims.size()) : -1;
}

pt_error pt_tensor_dims(const pt_tensor* t, int64_t* dims) {
  if (!t || !dims) return PT_NULLPTR;
  std::memcpy(dims, t->dims.data(), t->dims.size() * sizeof(int64_t));
  return PT_OK;
}

int64_t pt_tensor_numel(const pt_tensor* t) { return t ? t->numel() : 0; }

void* pt_tensor_data(pt_tensor* t) {
  if (!t || t->borrow) return nullptr;   // borrowed views are read-only
  return t->owned.data();
}

const void* pt_tensor_data_const(const pt_tensor* t) {
  return t ? t->data() : nullptr;
}

// ---- predictor ------------------------------------------------------------
pt_predictor* pt_predictor_load(const char* model_dir) {
  auto* p = new pt_predictor();
  if (!model_dir) {
    p->error = "model_dir is NULL";
    return p;
  }
  p->h = infer_cpu_load(model_dir);
  const char* err = infer_cpu_error(p->h);
  if (err && err[0]) {
    p->error = err;
  } else {
    p->load_ok = true;
  }
  return p;
}

void pt_predictor_destroy(pt_predictor* p) {
  if (!p) return;
  if (p->h) infer_cpu_destroy(p->h);
  delete p;
}

pt_error pt_predictor_ok(const pt_predictor* p) {
  if (!p) return PT_NULLPTR;
  return p->load_ok ? PT_OK : PT_RUNTIME_ERROR;
}

const char* pt_predictor_error(const pt_predictor* p) {
  return p ? p->error.c_str() : "predictor is NULL";
}

int64_t pt_predictor_num_inputs(const pt_predictor* p) {
  return (p && p->h) ? infer_cpu_num_feeds(p->h) : 0;
}

const char* pt_predictor_input_name(const pt_predictor* p, int64_t i) {
  if (!p || !p->h || i < 0 || i >= infer_cpu_num_feeds(p->h)) return nullptr;
  return infer_cpu_feed_name(p->h, i);
}

int64_t pt_predictor_num_outputs_expected(const pt_predictor* p) {
  return (p && p->h) ? infer_cpu_num_fetches(p->h) : 0;
}

const char* pt_predictor_output_name(const pt_predictor* p, int64_t i) {
  if (!p || !p->h || i < 0 || i >= infer_cpu_num_fetches(p->h))
    return nullptr;
  return infer_cpu_fetch_name(p->h, i);
}

pt_error pt_predictor_set_input(pt_predictor* p, const char* name,
                                const pt_tensor* t) {
  if (!p || !p->h || !name || !t) return PT_NULLPTR;
  int rc = infer_cpu_stage_feed(p->h, name, static_cast<int>(t->dtype),
                                t->dims.data(),
                                static_cast<int64_t>(t->dims.size()),
                                t->data());
  if (rc != 0) {
    p->error = infer_cpu_error(p->h);
    return PT_RUNTIME_ERROR;
  }
  return PT_OK;
}

pt_error pt_predictor_run(pt_predictor* p) {
  if (!p || !p->h) return PT_NULLPTR;
  p->outputs.clear();
  int64_t n = infer_cpu_run(p->h);
  if (n < 0) {
    p->error = infer_cpu_error(p->h);
    p->n_outputs = 0;
    return PT_RUNTIME_ERROR;
  }
  p->n_outputs = n;
  p->outputs.resize(n);
  for (int64_t i = 0; i < n; i++) {
    pt_tensor& t = p->outputs[i];
    t.dtype = static_cast<pt_dtype>(infer_cpu_output_dtype(p->h, i));
    t.dims.resize(infer_cpu_output_ndim(p->h, i));
    infer_cpu_output_dims(p->h, i, t.dims.data());
    t.borrow = infer_cpu_output_data(p->h, i);
  }
  return PT_OK;
}

int64_t pt_predictor_num_outputs(const pt_predictor* p) {
  return p ? p->n_outputs : 0;
}

const pt_tensor* pt_predictor_output(const pt_predictor* p, int64_t i) {
  if (!p || i < 0 || i >= p->n_outputs) return nullptr;
  return &p->outputs[i];
}

}  // extern "C"
