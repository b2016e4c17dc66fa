// Kernel 6, the reverse sweep of the SDE-GAN generator's whole solve
// (gan_gen_bwd.cuh), in bf16 mixed mode: its C entry point, a source of its
// own so that nvcc builds it beside the float32 one (gan_gen_bwd.cu).

#include <cuda_bf16.h>

#include "gan_gen_bwd.cuh"

extern "C" {

// bf16 mixed mode: the noise, the weights and dnoise bf16, the rest as
// above (the partials and dw float32: the weights' gradients summed in
// float32, for the caller to round once).
int tsde_gan_gen_bwd_bf16(
    const float* g0, const __nv_bfloat16* noise, const float* t1s,
    const float* dts, const __nv_bfloat16* W1f, const __nv_bfloat16* b1f,
    const __nv_bfloat16* W2f, const __nv_bfloat16* b2f,
    const __nv_bfloat16* W1g, const __nv_bfloat16* b1g,
    const __nv_bfloat16* W2g, const __nv_bfloat16* b2g, const float* zs,
    const float* gs, const float* gy, float* dx0, float* df0, float* dg0,
    __nv_bfloat16* dnoise, float* partials, float* dw, int B, int S, int M,
    int m, int N, int threads, int device, cudaStream_t stream) {
  const __nv_bfloat16* w[8] = {W1f, b1f, W2f, b2f, W1g, b1g, W2g, b2g};
  return launch_gen_bwd(g0, noise, t1s, dts, w, zs, gs, gy, dx0, df0, dg0,
                        dnoise, partials, dw, B, S, M, m, N, threads, device,
                        stream);
}

}  // extern "C"
