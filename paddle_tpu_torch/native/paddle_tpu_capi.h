// paddle_tpu C inference API — the embeddable deploy surface.
//
// Parity target: paddle/capi in the reference (capi.h, matrix.h,
// arguments.h, gradient_machine.h: paddle_gradient_machine_forward et al.)
// — a pure-C API for server/mobile embeds with opaque handles and error
// codes.  Redesigned for this framework's artifact format: a predictor
// loads the directory written by paddle_tpu.io.save_inference_model
// (JSON __model__ + one .npy per persistable) and executes it natively;
// tensors are dense row-major buffers.
//
// Usage (see tests/test_capi.py for a driven example):
//   pt_predictor* p = pt_predictor_load("/path/to/model");
//   if (!p || pt_predictor_ok(p) != PT_OK) { ...pt_predictor_error(p)... }
//   pt_tensor* in = pt_tensor_create(PT_F32, dims, ndim);
//   memcpy(pt_tensor_data(in), my_data, nbytes);
//   pt_predictor_set_input(p, "x", in);
//   if (pt_predictor_run(p) != PT_OK) { ... }
//   const pt_tensor* out = pt_predictor_output(p, 0);
//   ... pt_tensor_data_const(out), pt_tensor_dims(out) ...
//   pt_tensor_destroy(in);
//   pt_predictor_destroy(p);
#ifndef PADDLE_TPU_CAPI_H_
#define PADDLE_TPU_CAPI_H_

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum {
  PT_OK = 0,
  PT_NULLPTR = 1,
  PT_OUT_OF_RANGE = 2,
  PT_RUNTIME_ERROR = 3,
} pt_error;

// dtype codes match the .npy loader (npy.h DType)
typedef enum {
  PT_F32 = 0,
  PT_F64 = 1,
  PT_I32 = 2,
  PT_I64 = 3,
} pt_dtype;

typedef struct pt_tensor pt_tensor;
typedef struct pt_predictor pt_predictor;

// ---- tensors -------------------------------------------------------------
pt_tensor* pt_tensor_create(pt_dtype dtype, const int64_t* dims,
                            int64_t ndim);
void pt_tensor_destroy(pt_tensor* t);
pt_dtype pt_tensor_dtype(const pt_tensor* t);
int64_t pt_tensor_ndim(const pt_tensor* t);
// writes ndim entries into dims
pt_error pt_tensor_dims(const pt_tensor* t, int64_t* dims);
int64_t pt_tensor_numel(const pt_tensor* t);
void* pt_tensor_data(pt_tensor* t);
const void* pt_tensor_data_const(const pt_tensor* t);

// ---- predictor -----------------------------------------------------------
// Loads a save_inference_model directory. Never returns NULL on allocation
// success; check pt_predictor_ok + pt_predictor_error for load failures.
pt_predictor* pt_predictor_load(const char* model_dir);
void pt_predictor_destroy(pt_predictor* p);
pt_error pt_predictor_ok(const pt_predictor* p);
const char* pt_predictor_error(const pt_predictor* p);

int64_t pt_predictor_num_inputs(const pt_predictor* p);
const char* pt_predictor_input_name(const pt_predictor* p, int64_t i);
int64_t pt_predictor_num_outputs_expected(const pt_predictor* p);
const char* pt_predictor_output_name(const pt_predictor* p, int64_t i);

// Stages a copy of `t` as the named input for the next run.
pt_error pt_predictor_set_input(pt_predictor* p, const char* name,
                                const pt_tensor* t);
// Runs the program on the staged inputs (paddle_gradient_machine_forward
// analog). On success outputs are available until the next run.
pt_error pt_predictor_run(pt_predictor* p);
int64_t pt_predictor_num_outputs(const pt_predictor* p);
// Borrowed view — valid until the next pt_predictor_run/destroy.
const pt_tensor* pt_predictor_output(const pt_predictor* p, int64_t i);

#ifdef __cplusplus
}  // extern "C"
#endif

#endif  // PADDLE_TPU_CAPI_H_
