// Online-softmax (flash) attention on Hopper, f32 or bf16 inputs, in the
// model layout:
//   q, o (B, S, H, hd);  k, v (B, T, KV, hd);  H % KV == 0 (GQA maps
//   query head h to key/value head h / (H / KV), no repeat in memory).
// Replaces the Pallas kernel _attn_kernel (flash_attention_bhsd) of
// src/repro/kernels/flash_attention/kernel.py, with its whole function:
// q, k, v read in their own type and computed on in f32, scale
// 1/sqrt(hd), optional tanh softcap, causal and sliding-window masks
// filled with NEG_INF (keys past T get -inf), the normaliser l clamped at
// 1e-30, and o written in q's type (bf16 rounded to nearest even).  hd is
// a multiple of 8 up to 256 (one template instance per type and hd / 8);
// S and T are any length.  The f32 body is in flash_attention.cuh; the
// bf16 instances, a design of their own on the bf16 tensor cores, are
// in flash_attention_bf16.cu, built beside the f32 ones here, so nvcc
// compiles the two halves in parallel.  With a non-null lse the kernel
// also writes each row's log-sum-exp m + log(max(l, 1e-30)) (B, H, S),
// which the backward (flash_attention_bwd.cu, f32 or bf16 up to hd 256)
// recomputes P from; serving passes null.
//
// Bound on the H100: at the router's shapes (S = T = 128, hd 32 or 40,
// f32) the operations (4 S T hd per head) outweigh the bytes on the f32
// CUDA cores; on the tensor cores the bytes bound it.  At the zoo's
// prefill shapes (bf16, S 512-4608, hd 64-256) the operations bound it.
// The f32 instances run both products on the TF32 tensor cores
// (mma.sync.m16n8k8) in 3xTF32 (mma_tf32.cuh): q (pre-scaled), k, P and
// v each split into big and small TF32 halves.  One TF32 pass keeps
// about 11 bits and fails the f32 tolerances.  The bf16 instances
// (flash_attention_bf16.cu) run on the bf16 tensor cores: q k^T in one
// pass, P V in two (P's bf16 pieces against the exact V).
// Design of the f32 instances:
// * One warp owns 16 query rows.  A block holds 1, 2 or 4 warps: the
//   caller's choice (the wrapper's launch-config table), or by default
//   the most that still gives at least one block per SM (132) for this
//   call's B * H * ceil(S / 16) * column-splits row tiles.  The grid is
//   (query tiles, B * H, column splits).
// * hd above 128: O's accumulator (4 registers per 8 columns a lane)
//   would take 128 registers at hd 256 and spill.  The output columns
//   are split in two halves, one block each (grid.z); each computes the
//   whole S = q k^T (all hd columns of q and K) and its half of P V.  S
//   is computed twice: the simplest plan that stays in registers.
// * The warp's q rows sit in registers as A fragments (up to hd 64), else
//   in the warp's own rows of shared memory (registers would spill), as
//   f32 (pre-scaled for f32 inputs, exact for bf16); f32 fragments are
//   split into big/small TF32 halves at each use.
// * K and V tiles are staged in shared memory in the input type with
//   cp.async, double-buffered: the next tile loads while this one is
//   used.  A tile is 64 keys, 32 for f32 above hd 128 (two stages of
//   64 f32 keys of 256 + 128 columns would not fit in 227 KB beside q).
//   Rows are padded by 16 bytes, so the B-fragment loads of S = q k^T
//   (8 keys x 4 dims per warp) and of P V (4 key pairs x 8 dims) spread
//   over the banks.
// * Tiles that every row of the block masks are skipped: keys past the
//   block's last row under the causal mask, keys at or before its first
//   row minus the window.  A masked key adds exp(NEG_INF - m) = 0 to a
//   row that has a live key, so the result is unchanged; where a row of
//   the block sees no key at all (only past T with a window), nothing is
//   skipped and such rows keep the Pallas kernel's uniform average.
// * S = q k^T accumulates in mma fragments, 32 keys at a time; softcap
//   and the masks are applied there, and the online softmax runs in
//   registers: a row's 8 values per lane, then a shuffle across the 4
//   lanes that share it.
// * P V needs P as an A fragment.  The accumulator gives lane (g, t)
//   keys 2t and 2t+1 of a k-step, where A wants t and t+4; the k index
//   of the product is permuted instead (A column t <-> key 2t, column
//   t+4 <-> key 2t+1, and V's rows read in the same order), so P moves
//   into A with no shuffle and no shared-memory stage.
// * The epilogue divides by max(l, 1e-30) and stores pairs in the model
//   layout (float2, or bf16x2 rounded to nearest even).
#include "flash_attention.cuh"

namespace tryage {
// flash_attention_bf16.cu: the bf16 instances
int flash_attention_bf16(int kd, const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int T, int H,
                         int KV, int causal, int window, float softcap,
                         float scale, int warps, cudaStream_t stream);
}  // namespace tryage

// bf16: 0 for f32 inputs and output, 1 for bf16 (lse stays f32).
// warps: a block's warps, 1, 2 or 4, or 0 for the default (see Design).
extern "C" int tryage_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int S, int T, int H, int KV,
                                      int hd, int causal, int window,
                                      float softcap, float scale, int bf16,
                                      int warps, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || hd % 8 || hd < 8 || hd > 8 * kMaxKD ||
      (bf16 != 0 && bf16 != 1) ||
      (warps != 0 && warps != 1 && warps != 2 && warps != kMaxWarps))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return tryage::flash_attention_bf16(hd / 8, q, k, v, o, lse, B, S, T, H,
                                        KV, causal, window, softcap, scale,
                                        warps, st);
  return dispatch<float, 1>(hd / 8, q, k, v, o, lse, B, S, T, H, KV, causal,
                            window, softcap, scale, warps, st);
}
