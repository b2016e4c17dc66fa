// Kernel 6, the reverse sweep of the SDE-GAN generator's whole solve
// (gan_gen_bwd.cuh), with float32 weights and noise: its C entry points.
// gan_gen_bwd_bf16.cu is the bf16 mixed mode's kernel.

#include "gan_gen_bwd.cuh"

extern "C" {

// Dynamic shared memory one block of the sweep needs for these widths at
// `threads` threads a block.
size_t tsde_gan_gen_bwd_smem_bytes(int S, int M, int m, int threads) {
  return gen_bwd_smem_floats(S, M, m, threads / 32) * sizeof(float);
}

// Weight-gradient partials of either backward kernel for a batch of B rows:
// the partial buffer holds one row of all weight gradients for each.
int tsde_gan_bwd_partials(int B, int S, int M) {
  return bwd_partials(B, S, M);
}

// Launches the sweep (`threads` threads per block) and the sum of its
// partials on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for widths beyond the kernel's limits (S, M <= 32,
// m <= 8, threads a multiple of 32 up to 256). All pointers are device
// pointers to contiguous float32 arrays; weights in the order of
// gan_fused.GEN_WEIGHT_NAMES. partials holds tsde_gan_bwd_partials(B, S, M)
// x P floats and dw P floats, P the weights' total element count; dw
// receives their gradients back to back.
int tsde_gan_gen_bwd(const float* g0, const float* noise, const float* t1s,
                     const float* dts, const float* W1f, const float* b1f,
                     const float* W2f, const float* b2f, const float* W1g,
                     const float* b1g, const float* W2g, const float* b2g,
                     const float* zs, const float* gs, const float* gy,
                     float* dx0, float* df0, float* dg0, float* dnoise,
                     float* partials, float* dw, int B, int S, int M, int m,
                     int N, int threads, int device, cudaStream_t stream) {
  const float* w[8] = {W1f, b1f, W2f, b2f, W1g, b1g, W2g, b2g};
  return launch_gen_bwd(g0, noise, t1s, dts, w, zs, gs, gy, dx0, df0, dg0,
                        dnoise, partials, dw, B, S, M, m, N, threads, device,
                        stream);
}

}  // extern "C"
