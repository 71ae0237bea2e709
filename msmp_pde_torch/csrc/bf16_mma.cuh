// The bf16 precision modes of the message-passing kernels (mp_phases.cuh):
// the rounding of a product's operands to bf16, bf16 storage of the inputs,
// and the bf16 products on the tensor cores.
//
// The modes follow mp_pallas.py::_parse_mm: 0 is float32; 1 (bfloat16)
// rounds both operands of every product to bf16, round to nearest even,
// and accumulates their exact products in float32; 2 (bfloat16s, storage)
// runs the same products on inputs and weight matrices that the wrapper
// cast to bf16 once before the launch, which the loaders read as 2-byte
// values. Biases, the elementwise passes, the InstanceNorm and every sum of
// a gradient stay float32 in every mode.
#pragma once
#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

namespace mp {

using bf16 = __nv_bfloat16;

// The element type of the inputs and weight matrices in mode MM.
template <int MM>
using In = std::conditional_t<MM == 2, bf16, float>;

__device__ __forceinline__ float f32(float x) { return x; }
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }

// x rounded to bf16 (to nearest, ties to even) and widened back
__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two values as one register of a bf16 mma fragment, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b for one m16n8k16 bf16 tile (a row-major, b column-major), the
// products exact and the sum in float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mp
