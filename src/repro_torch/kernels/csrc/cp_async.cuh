// Shared by the kernels that stage global memory in shared memory by
// cp.async (gemm_mma.cuh's loop; the depthwise convs' ring,
// depthwise_rows.cuh): the shared-memory address of a pointer, the copy of
// 16, 8, 4 or 2 bytes with zeros where the source is not valid, and the
// commit and wait of a group of copies.
#pragma once

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8 or 4) from global to shared memory, or zeros where !valid
// (cp.async reads src-size 0 bytes then; the .L2::128B hint has the L2
// fetch whole lines, which a stream of row pieces then reuses). 2 bytes,
// under cp.async's least size, is a plain load and store.
template <int BYTES>
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        bool valid) {
  const unsigned d = smem_addr(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile(
        "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d),
        "l"(src), "r"(n));
  else if constexpr (BYTES == 8 || BYTES == 4)
    asm volatile(
        "cp.async.ca.shared.global.L2::128B [%0], [%1], %2, %3;\n" ::"r"(d),
        "l"(src), "n"(BYTES), "r"(n));
  else
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src)
              : static_cast<unsigned short>(0);
}

__device__ __forceinline__ void copy_in(void* dst, const void* src, int bytes,
                                        bool valid) {
  switch (bytes) {
    case 16: copy_in<16>(dst, src, valid); break;
    case 8: copy_in<8>(dst, src, valid); break;
    case 4: copy_in<4>(dst, src, valid); break;
    default: copy_in<2>(dst, src, valid);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
