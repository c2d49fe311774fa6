// 0/1 int8 indicator rows from packed sketch ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel drep_tpu/ops/pallas_indicator.py::_indicator_kernel
// (grid _indicator_pallas_jit). Row r of the output is 1 at every id of
// ids[r] below v_pad and 0 elsewhere; ids >= v_pad (PAD_ID included) are
// ignored — the semantics of the JAX package's scatter into a trash column,
// and of ops/indicator.py::indicator_plain.
//
// What bounds it here: bytes. The work is a zero-fill of m * v_pad bytes
// plus one byte store per real id; no arithmetic to speak of. The TPU kernel
// walks each row in a while loop and ORs a 128-lane one-hot into a VMEM
// row because Mosaic has no byte store at an arbitrary offset; Hopper has
// one, so each id is a single scattered store.
//
// Design: one block per row. The block zero-fills its row with 16-byte
// stores (v_pad is a multiple of 16), synchronises, then its threads stride
// over the row's ids and store a 1 byte at each id < v_pad. Fusing the
// scatter into the int8 GEMM that reads these rows (so the indicator never
// touches device memory) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__global__ void indicator_kernel(const int32_t* __restrict__ ids, int8_t* __restrict__ out,
                                 int width, int v_pad) {
  const int64_t row = blockIdx.x;
  int8_t* orow = out + row * (int64_t)v_pad;
  int4* orow16 = reinterpret_cast<int4*>(orow);
  const int4 zero = make_int4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < v_pad / 16; c += THREADS) orow16[c] = zero;
  __syncthreads();
  const int32_t* irow = ids + row * (int64_t)width;
  for (int c = threadIdx.x; c < width; c += THREADS) {
    const int32_t id = irow[c];
    if (id >= 0 && id < v_pad) orow[id] = 1;
  }
}

extern "C" int indicator_launch(const int32_t* ids, int8_t* out, int m, int width, int v_pad,
                                void* stream) {
  if (m > 0) {
    indicator_kernel<<<m, THREADS, 0, (cudaStream_t)stream>>>(ids, out, width, v_pad);
  }
  return (int)cudaGetLastError();
}
