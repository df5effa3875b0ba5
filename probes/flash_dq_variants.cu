// Forms of the float32 dq kernel (kernels/csrc/flash_bwd.cu's
// `flash_bwd_dq_tf32`) that the port does not take, for
// probes/flash_dq_ab.py. This file includes the kernel's source, so every
// form is the port's code with other template arguments. Built by
// `build_probe` (kernels/csrc on the include path).
//
//   D 16, 32, 64 (no dropout): variant 0 the port's 64-row kv tiles,
//              variant 1 32-row kv tiles
//   D 128 (with and without dropout), 32-row kv tiles: the score
//              products' k-steps in unrolled runs of RUN and dQ += dS K in
//              passes of PASS k-steps, (RUN, PASS) = (8, 4), (4, 4),
//              (8, 2), (4, 2), (2, 2) for variants 0-4; the port takes
//              (8, 4) with dropout and (4, 2) without (flash_bwd.cu's
//              DqForm)

#include "flash_bwd.cu"

namespace {

template <bool DROP>
int launch_d128(int variant, const Params& p, cudaStream_t s) {
  switch (variant) {
    case 0: return launch_dq_tf32<128, DROP, 32, 8, 4>(p, s);
    case 1: return launch_dq_tf32<128, DROP, 32, 4, 4>(p, s);
    case 2: return launch_dq_tf32<128, DROP, 32, 8, 2>(p, s);
    case 3: return launch_dq_tf32<128, DROP, 32, 4, 2>(p, s);
    case 4: return launch_dq_tf32<128, DROP, 32, 2, 2>(p, s);
    default: return -1;
  }
}

template <int D>
int launch_variant(int variant, bool drop, const Params& p, cudaStream_t s) {
  if constexpr (D == 128) {
    return drop ? launch_d128<true>(variant, p, s) : launch_d128<false>(variant, p, s);
  } else {
    if (drop) return -1;
    switch (variant) {
      case 0: return launch_dq_tf32<D, false, 64>(p, s);
      case 1: return launch_dq_tf32<D, false, 32>(p, s);
      default: return -1;
    }
  }
}

}  // namespace

// flash_bwd_dq's float32 arguments after the variant (dropout only at D
// 128)
extern "C" int flash_bwd_dq_variant(int variant, int head_dim, const void* q, const void* k,
                                    const void* v, const void* dout, const float* lse,
                                    const float* delta, void* dq, int B, int N, int Nkv, int Sq,
                                    int Skv, float scale, int causal, int dropout,
                                    unsigned long long seed, unsigned int threshold,
                                    float drop_scale, void* stream) {
  const Params p{q,     k,      v,    dout,      lse,        delta, dq,     nullptr, nullptr,
                 B,     N,      Nkv,  Sq,        Skv,        scale, causal, seed,    threshold,
                 drop_scale, 1, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool drop = dropout != 0;
  switch (head_dim) {
    case 16: return launch_variant<16>(variant, drop, p, s);
    case 32: return launch_variant<32>(variant, drop, p, s);
    case 64: return launch_variant<64>(variant, drop, p, s);
    case 128: return launch_variant<128>(variant, drop, p, s);
    default: return -1;
  }
}
