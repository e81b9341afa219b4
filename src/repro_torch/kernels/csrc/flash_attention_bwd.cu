// The gradient of flash attention (flash_attention.cu) on Hopper, in the
// model layout: from q, dO (B, S, H, hd), k, v (B, T, KV, hd), all f32 or
// all bf16, and the forward's f32 log-sum-exp lse (B, H, S), it writes
// dQ (B, S, H, hd) and dK, dV (B, T, KV, hd) in the inputs' type (bf16
// rounded to nearest even from f32 sums); hd is a multiple of 8 up to
// 256.  The f32 body is in flash_attention_bwd.cuh (an instance per hd /
// 8), the bf16 one in flash_attention_bwd_bf16.cuh (an instance per hd /
// 16 rounded up); the instances are built in eight parts side by side
// (flash_attention_bwd_part.cu), so that nvcc's time is spread over the
// cores.  The Pallas
// kernel _attn_kernel (src/repro/kernels/flash_attention/kernel.py) has
// no backward: the JAX
// package trains through attention with XLA's autodiff of
// attend_full(impl="xla").  This is that gradient, for the masks of the
// forward: the scale 1/sqrt(hd) on the scores, the optional tanh softcap
// (dS is multiplied by 1 - tanh^2), causal and sliding-window masks (a
// masked score gets no gradient, as jnp.where gives none), and GQA (dK
// and dV sum over the H / KV query heads of a group).  A row whose every
// key is masked took the uniform average of V in the forward (softmax of
// equal fills); its lse is the mask fill itself, and its P is 1 / T here.
//
// Algorithm (FlashAttention-2's backward, with the softmax statistics
// made consistent with the recomputed P): P = exp(S - lse),
// dP = dO V^T, and with each row's own sums of P and of P dP over all
// keys, P <- P / sum P, D = sum(P dP) / sum(P), dS = P (dP - D); then
//   dV = P^T dO,  dK = dS^T q / sqrt(hd),  dQ = dS K / sqrt(hd).
// The forward's 3xTF32 scores and these differ by rounding, so exp(S -
// lse) sums over a row to 1 + eps, not 1; with D = rowsum(dO * O) the
// rows of dS would sum to eps * D and dQ would pick up eps * D times the
// keys' common direction (1.02e-4 of a weight gradient's largest
// magnitude on the card).  Renormalised, the rows of dS sum to 0 up to
// rounding, as in the softmax backward of the plain version.
//
// Bound on the H100: five products of 2 S T hd operations a head (S and
// dP, dV, dK, dQ); at three TF32 passes each on the tensor cores (495
// TFLOP/s) the bytes (q, k, v, dO and lse read, dQ, dK, dV written, at
// 3.35 TB/s) bound it at the training shapes (S = T = 128, hd 32 or 40):
// 0.0044 ms at (B, H, hd) = (16, 8, 32); at the zoo's training shapes
// (bf16, S = T = 512-4608, hd 64-256) the operations bound it.  The f32
// instances run every product in 3xTF32 (mma_tf32.cuh): each f32
// operand, the computed P and dS too, is split into big and small TF32
// halves at use (split_tf32_rz: small is left for the tensor cores to
// truncate), which keeps f32 accuracy where one TF32 pass would not
// (tests/test_torch_tf32.py, tests/test_torch_attention_grad.py).  The
// bf16 instances have a design of their own on the bf16 tensor cores
// (flash_attention_bwd_bf16.cuh: two launches, tiles the masks leave
// empty skipped).  Design of the f32 instances:
// * A block of 8 warps (hd up to 128) owns a block of up to 128 keys of
//   one (batch, kv head), 16 keys a warp; K and V of the block stay in
//   shared memory.
//   It walks the group's query heads and their tiles of R query rows
//   (64, or 32 above hd 64) in a fixed order; each tile's q, dO and lse
//   arrive by cp.async, double-buffered, while the last tile is used.
//   Rows are padded to hd + 4 floats, so the fragment loads hit 32
//   different banks.
// * A warp computes S^T = K q^T and dP^T = V dO^T for its 16 keys and the
//   tile's rows, key-major as FlashAttention-2's dK/dV loop does, so
//   that P^T and dS^T sit in the accumulators as the A fragments of
//   dV += P^T dO and dK += dS^T q need them: lane (g, t) holds rows 2t
//   and 2t + 1 of each 8-row step, and the k index of those products is
//   permuted to match (A column t <-> row 2t, t + 4 <-> row 2t + 1, dO
//   and q read in the same order), as the forward does for P V.  dK and
//   dV accumulate in registers over all tiles, a tile's products for an
//   n-tile in a fresh accumulator first: the tensor cores' f32
//   accumulate truncates toward zero, and one chain over all tiles
//   drifts with its length (3.3e-4 of dK's largest value at 6,912
//   k-steps, starcoder2's 48:4 heads at 4,608 rows), where a tile's NR
//   k-steps and one rounded add do not.  dS^T's A fragments are read
//   back from shared memory at each use, so that no instance spills.
// * T <= 128 (every shape training runs: S = T = 128): one launch, S and
//   dP once per (row, key).  The row sums come from the same pass: each
//   warp reduces its 16 keys by shuffles (a reduce-scatter over the 8
//   lanes of a row), the 8 warps' partial sums meet in shared memory and
//   are added in warp order.  dS^T goes to shared memory, and dQ = dS K
//   for the tile follows at once, complete, by the 8 warps (a 16-row
//   group and a share of the head dim each, each 3xTF32 pass in its own
//   accumulator: few n-tiles a warp would leave one chain waiting on
//   mma.sync's latency).
// * When B * KV blocks would fill under half the SMs, a cluster of 2-8
//   blocks splits the tiles of each (batch, kv head) and adds its dK
//   and dV through distributed shared memory in rank order: at
//   (16, 4, 128, 40) that is 128 blocks on the 132 SMs, not 64
//   (PERF.md).
// * T > 128: two launches.  flash_attention_bwd_dq, a block per (b, h,
//   query tile), walks the key blocks twice, first for the row sums
//   (written out as 1 / sum P and D for the second launch), then for dS
//   and dQ; flash_attention_bwd_kernel then runs a block per (b, kv
//   head, key block) as above, with the row sums read, not summed, and
//   no dQ.  S and dP are computed three times there.
// * No branch inside an unrolled loop: the masks are selects, the
//   softcap a template argument, and the dQ loop's n-tile guard is known
//   at compile time where the split is even.  Even a uniform branch
//   there splits the loop into blocks whose exp and mma.sync latencies
//   cannot overlap, and the warps (8 a block, one block an SM) have few
//   others to hide them behind.
// * hd above 128 (gemma3's 256): at 128 keys a block, K and V alone
//   would take 2 x 128 x 260 x 4 B = 266 KB of shared memory (a block
//   may have 227 KB), and a warp's dK and dV for 16 keys 256 registers a
//   lane (a thread may have 255).  So a block has 4 warps and 64 keys,
//   one q/dO tile buffer (K, V, q and dO in f32 then take 200 KB: two
//   buffers would not fit), and the output columns are split in two
//   halves, one block each (grid.y), as the forward splits O: each block
//   computes the whole S and dP (all hd columns of q, K, dO, V) and its
//   half of dK, dV and dQ, so dK and dV take 128 registers a lane as at
//   hd 128.  S and dP are computed once for each half in each launch
//   (six times in all): the simplest plan that keeps the f32 inputs and
//   the accumulators on chip.  These instances always run
//   the two launches (the one-launch path would hold dQ's accumulators
//   beside dK's and dV's and spill).
// * No atomics: every sum runs in a fixed order, so a rerun gives
//   bit-identical gradients.
#include "flash_attention_bwd.cuh"

// rows: (B, H, S, 2) f32 workspace for the row sums, written and read
// only on the two-launch path (f32: T above the block's keys, 128 up to
// hd 128, 64 above, and every call above hd 128; bf16: every call), null
// otherwise.
// bf16: 0 for f32 inputs and outputs, 1 for bf16 (lse stays f32).
extern "C" int tryage_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* d_o,
    const float* lse, float* rows, void* dq, void* dk, void* dv, int B, int S,
    int T, int H, int KV, int hd, int causal, int window, float softcap,
    float scale, int bf16, void* stream) {
  using tryage::flash_attention_bwd_part;
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || hd % 8 || hd < 8 || hd > 8 * kMaxKD || KV <= 0 || H % KV ||
      (bf16 != 0 && bf16 != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const tryage::Args a = {q, k, v, d_o, lse, rows, dq, dk, dv, B, S, T, H,
                          KV, causal, window, softcap, scale};
  const int kd = hd / 8;
  if (bf16) {
    if (kd <= 8) return flash_attention_bwd_part<1, 1>(kd, a, st);
    if (kd <= 16) return flash_attention_bwd_part<1, 9>(kd, a, st);
    if (kd <= 24) return flash_attention_bwd_part<1, 17>(kd, a, st);
    return flash_attention_bwd_part<1, 25>(kd, a, st);
  }
  if (kd <= 8) return flash_attention_bwd_part<0, 1>(kd, a, st);
  if (kd <= 16) return flash_attention_bwd_part<0, 9>(kd, a, st);
  if (kd <= 24) return flash_attention_bwd_part<0, 17>(kd, a, st);
  return flash_attention_bwd_part<0, 25>(kd, a, st);
}
