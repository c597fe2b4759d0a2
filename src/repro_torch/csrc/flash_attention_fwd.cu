// Causal (or full) flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/flash_attention.py:
// flash_attention :71, _flash_kernel :34): q (B, Sq, H, hd) and k/v
// (B, Sk, KV, hd) with H % KV == 0, q head h reading KV head h % KV (the
// order of jnp.tile), in fp32 or bf16; s = (q . k) * 1/sqrt(hd) in fp32,
// masked to -1e30 where the key is past Sk or, when causal, past the
// query's absolute position (q_offset + i >= j); an online softmax over kv
// tiles keeps the running max m, sum l and output sum in fp32; the output
// is acc / max(l, 1e-30) in q's dtype.  Any Sq and Sk: the last q and kv
// tiles are masked.  Head dims 32, 64 and 128.
//
// Bound on the H100: at the qwen3-0.6b prefill (B 4, S 1024, H 16, KV 8,
// hd 64, bf16, causal) the causal half of 4 * B * H * S^2 * hd operations
// at the bf16 tensor-core peak (0.0087 ms) binds; q, o and the 8 KV heads
// of k and v (25.2 MB) take 0.0075 ms.
//
// bf16 (the prefill's path): a warp-specialised tensor-core kernel.
//  * One block per (b * h, 128-row q tile), heaviest (last) q tiles first:
//    two consumer warpgroups own 64 q rows each; one thread of a producer
//    warpgroup issues every load.  setmaxnreg moves registers from the
//    producer (40) to the consumers (232).
//  * Loads are TMA (cp.async.bulk.tensor, completion on an mbarrier) of
//    bf16 tiles straight from the untiled (B, S, KV, hd) tensors, so K/V are
//    read at their KV heads and never copied; rows past Sq or Sk arrive as
//    zeros.  The tiles land in the 128-byte (hd 32: 64-byte) swizzle that
//    wgmma reads without bank conflicts.  Q stays in shared memory for the
//    whole block; K and V go through a ring of kStages 64-key stages, one
//    full (TMA) and one empty (consumer) barrier a stage, so later tiles
//    load while the current one is computed.
//  * S = Q . K^T is wgmma m64n64k16, both operands from shared memory, the
//    fp32 sum in registers.  The softmax runs in the accumulator's layout:
//    a row lives in the 4 lanes of a quad, so a row max or sum is a tree in
//    registers and two shuffles; the scale folds into one FFMA before
//    ex2.  Only the diagonal tile and the ragged last tile are masked; the
//    causal loop stops at each warpgroup's last diagonal key.
//  * O += P . V is two wgmma m64nHDk16 passes over each 16-key slice, P
//    from registers and V from shared memory (MN-major): first
//    P_hi = bf16(P), then P_lo = bf16(P - P_hi).  Together they carry P to
//    about 2^-16 relative, so the result stays within one bf16 rounding of
//    the plain version, which keeps P in fp32 (a single bf16 P would not).
//    The split costs 1.5x the function's tensor-core work.
//  * Tile t's Q . K^T is issued together with tile t - 1's P . V, so that
//    P . V runs on the tensor cores during tile t's softmax.  Every wait on
//    a barrier is one asm loop, so ptxas sees no divergent branch between
//    the wgmma instructions and keeps them asynchronous.
// fp32 (the parity paths): the scalar kernel below, one block of 4 warps
// per (b*h, 64-row q tile), fp32 tiles in shared memory, fp32 FMAs; it
// matches the plain version to fp32 rounding, which TF32 would not.
//
// Training: given an lse buffer (fp32, (B, H, Sq)), both kernels also
// write each row's log-sum-exp of its scaled scores, m + log(l) in natural
// units (the bf16 kernel keeps m raw and l in base-2 units, so it writes
// (m * scale_log2 + log2 l) * ln 2), which the backward
// (flash_attention_bwd.cu) exponentiates as exp(s * scale - lse).  A null
// lse (every serving launch) skips the store and leaves the rest as it is.
#include "flash_hopper.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// fp32: the scalar kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPStride = kBK + 8;  // rows of a warp's P tile: 8 banks apart

template <int HD>
constexpr int smem_floats() {
  return 2 * kBQ * (HD + 1) + kBK * HD + kWarps * 16 * kPStride;
}

// Each warp owns 16 q rows; lane (rg, cg) = (lane / 8, lane % 8) holds rows
// rg + 4i (i < 4) and keys cg + 8j (j < 8) of the score tile and columns
// cg + 8c (c < hd / 8) of the output, so a row's max and sum reduce over
// the 8 lanes of its row group with three shuffles, and every
// shared-memory access is conflict-free (padded strides).
template <int HD>
__global__ void __launch_bounds__(kThreads) flash_attention_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int n_heads, int n_kv, int sq, int sk,
    int causal, int q_offset, float scale) {
  constexpr int QS = HD + 1;  // padded row stride of the q and k tiles
  constexpr int NC = HD / 8;  // output columns per lane
  extern __shared__ float smem[];
  float* s_q = smem;               // kBQ x QS
  float* s_k = s_q + kBQ * QS;     // kBK x QS
  float* s_v = s_k + kBK * QS;     // kBK x HD
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* s_p = s_v + kBK * HD + warp * 16 * kPStride;  // this warp's 16 rows
  const int rg = lane / 8, cg = lane % 8;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads;
  const long long rs = (long long)n_heads * HD;  // q / o sequence-row stride
  const long long rk = (long long)n_kv * HD;     // k / v sequence-row stride
  const float* qb = q + ((long long)b * sq * n_heads + h) * HD;
  const float* kb = k + ((long long)b * sk * n_kv + h % n_kv) * HD;
  const float* vb = v + ((long long)b * sk * n_kv + h % n_kv) * HD;
  float* ob = o + ((long long)b * sq * n_heads + h) * HD;

  for (int e = threadIdx.x; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, c = e % HD;
    s_q[r * QS + c] = q0 + r < sq ? qb[(q0 + r) * rs + c] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  // keys [0, kv_end) can be visible to this q tile
  int kv_end = sk;
  if (causal) {
    const long long last = (long long)q_offset + min(q0 + kBQ, sq);
    kv_end = (int)min((long long)sk, last);
  }
  const int n_tiles = (kv_end + kBK - 1) / kBK;
  const int row0 = warp * 16 + rg;  // this lane's first row in the q tile

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's k/v reads are done
    for (int e = threadIdx.x; e < kBK * HD; e += kThreads) {
      const int r = e / HD, c = e % HD;
      const bool ok = k0 + r < sk;
      s_k[r * QS + c] = ok ? kb[(k0 + r) * rk + c] : 0.f;
      s_v[r * HD + c] = ok ? vb[(k0 + r) * rk + c] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(row0 + 4 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = s_k[(cg + 8 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = (long long)q_offset + q0 + row0 + 4 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        const bool ok = kpos < sk && (!causal || qpos >= kpos);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
        s_p[(rg + 4 * i) * kPStride + cg + 8 * j] = s[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(kFullMask, sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(rg + 4 * i) * kPStride + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = s_v[j * HD + cg + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
    __syncwarp();  // the P tile is rewritten by the next kv tile
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + row0 + 4 * i;
    if (r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[r * rs + cg + 8 * c] = acc[i][c] / den;
    if (lse != nullptr && cg == 0)
      lse[((long long)b * n_heads + h) * sq + r] = m[i] + logf(den);
  }
}

template <int HD>
static int launch_f32(const void* q, const void* k, const void* v, void* o,
                      float* lse, int b, int h, int n_kv, int sq, int sk,
                      int causal, int q_offset, cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * (int)sizeof(float);
  auto kernel = flash_attention_fwd_f32_kernel<HD>;
  static bool opted_in[kMaxDevices] = {};
  // above 48 KB only as opted-in dynamic shared memory
  const int e = opt_in_smem(kernel, bytes, opted_in);
  if (e) return e;
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  const float scale = (float)(1.0 / sqrt((double)(HD)));
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, h,
      n_kv, sq, sk, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kStages = 4;  // K/V ring depth

template <int HD>
struct Tc {
  static constexpr int TQ = 128;         // q rows per block
  static constexpr int CONSUMERS = 256;  // two consumer warpgroups of 64 rows
  static constexpr int THREADS = CONSUMERS + 128;  // + a producer warpgroup
  // registers a thread after setmaxnreg: 256 x 232 + 128 x 40 <= 64 K
  static constexpr int CONSUMER_REGS = 232;
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int BK = 64;                    // keys per kv tile
  static constexpr int CW = HD < 64 ? HD : 64;     // columns per swizzle atom
  static constexpr int NCH = HD / CW;              // atoms across hd
  static constexpr int SWB = CW * 2;               // swizzle span, bytes
  static constexpr int Q_BYTES = TQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;
  // Q, then kStages x (K, V), then the barriers; + 1 KB to align the base
  static constexpr int BAR_OFF = Q_BYTES + kStages * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * kStages) + 1024;
};

// One row's reduction over a score tile in the accumulator layout: the
// pairs x[4 j], x[4 j + 1] for j < N (the row r + 8 starts at x + 2), as a
// tree, so the dependent chain is log2(2 N) deep.
template <int N, typename Op>
__device__ __forceinline__ float tree(const float* x, Op op) {
  float t[N];
#pragma unroll
  for (int j = 0; j < N; ++j) t[j] = op(x[4 * j], x[4 * j + 1]);
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2)
#pragma unroll
    for (int j = 0; j < w; ++j) t[j] = op(t[j], t[j + w]);
  return t[0];
}
struct FmaxOp {
  __device__ float operator()(float a, float b) const { return fmaxf(a, b); }
};
struct AddOp {
  __device__ float operator()(float a, float b) const { return a + b; }
};
constexpr FmaxOp fmaxf_op{};
constexpr AddOp add_op{};

// The consumer warpgroups' part of the kernel.
template <int HD>
__device__ __forceinline__ void consumer(
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, uint32_t s_q,
    uint32_t s_k0,
    uint32_t bar_q, uint32_t bar_f0, uint32_t bar_e0,
    int n_heads, int sq, int sk, int causal, int q_offset, float scale_log2,
    int q0, int b, int h, int n_tiles) {
  using C = Tc<HD>;
  constexpr int BK = C::BK, CW = C::CW, SWB = C::SWB;
  constexpr int NS = BK / 2;   // score registers a thread: 64 x BK / 128
  constexpr int NO = HD / 2;   // output registers a thread: 64 x HD / 128
  constexpr int KS = BK / 16;  // 16-key slices of a kv tile
  const int warp = __shfl_sync(kFullMask, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  // a consumer warpgroup: 64 q rows; this thread holds rows r and r + 8 of
  // them, and of every 8-column group of S and O the columns 2 (lane % 4)
  // and 2 (lane % 4) + 1
  const int wg = warp / 4;
  const int qw = q0 + wg * 64;
  const int r = (warp % 4) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
  const int my_tiles =
      (kv_end(qw + 64, sq, sk, causal, q_offset) + BK - 1) / BK;
  // this warpgroup's Q rows: K-major, 8-row groups 8 swizzled rows apart
  const uint64_t dq = gmma_desc(s_q + wg * 64 * SWB, 16, 8 * SWB, SWB);
  auto stage = [](unsigned t) { return t % kStages; };
  auto parity = [](unsigned t) { return (t / kStages) & 1; };
  auto k_tile = [&](unsigned t) { return s_k0 + stage(t) * 2 * C::KV_BYTES; };
  // this warp is done with tile t's stage
  auto release = [&](unsigned t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e0 + 8 * stage(t));
  };
  // tile t's K and V are in their stage
  auto wait_full = [&](unsigned t) {
    mbar_wait(bar_f0 + 8 * stage(t), parity(t));
  };

  float oacc[NO], sacc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  // Scores stay in raw units until the exponent, exp(s * scale - m) =
  // exp2(s * scale_log2 - m_log2), one FFMA; a masked score is
  // -1e30 / scale_log2 (-1e30 in log2 units, as the reference masks).
  // Key 0 is visible to every row, so each row's max is a real score from
  // the first tile on.
  const float mask_raw = kNegInf / scale_log2;
  // running max (raw units) and sum of rows r and r + 8
  float m[2] = {mask_raw, mask_raw}, l[2] = {0.f, 0.f};
  uint32_t phi[KS][4], plo[KS][4];  // P of the tile whose P.V is pending

  // S = Q K^T of tile t, issued (zeroed first: the last P is dead by then)
  auto issue_qk = [&](unsigned t) {
#pragma unroll
    for (int i = 0; i < NS; ++i) sacc[i] = 0.f;
    const uint64_t dk = gmma_desc(k_tile(t), 16, 8 * SWB, SWB);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      // 16 columns on within the swizzle atom, or the next atom
      const int step = (kk * 16 / CW) * C::TQ * SWB + (kk * 16 % CW) * 2;
      const int kstep = (kk * 16 / CW) * BK * SWB + (kk * 16 % CW) * 2;
      wgmma_ss_n64(sacc, dq + (step >> 4), dk + (kstep >> 4), kk > 0);
    }
    wgmma_commit();
  };
  // O += P_hi V, then O += P_lo V for tile t, issued
  auto issue_pv = [&](unsigned t) {
    const uint64_t dv =
        gmma_desc(k_tile(t) + C::KV_BYTES, BK * SWB, 8 * SWB, SWB);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(oacc, phi[kk], dv + ((kk * 16 * SWB) >> 4));
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs<HD>(oacc, plo[kk], dv + ((kk * 16 * SWB) >> 4));
    wgmma_commit();
  };
  // mask (MASK: the diagonal or ragged tile) and exponentiate tile t's
  // scores in place; update m and l; return each row's correction of the
  // output sum
  auto softmax = [&](auto mask_tag, unsigned t, float* corr) {
    constexpr bool MASK = decltype(mask_tag)::value;
#pragma unroll
    for (int i = 0; i < NS; ++i) fence_regs(sacc[i]);
    // row i sees the keys of this tile whose offset from t BK + cq is
    // below vis[i]
    int vis[2];
    if (MASK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int lim = sk;
        if (causal) lim = min(lim, q_offset + qw + r + 8 * i + 1);
        vis[i] = lim - (int)(t * BK) - cq;
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + (e & 1) >= vis[e >> 1]) sacc[4 * j + e] = mask_raw;
    }
    float mx[2], mc[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(m[i], tree<BK / 8>(sacc + 2 * i, fmaxf_op));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFullMask, mx[i], 2));
      mc[i] = mx[i] * scale_log2;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sacc[4 * j + e] =
            fast_exp2(fmaf(sacc[4 * j + e], scale_log2, -mc[e >> 1]));
    float sum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] = tree<BK / 8>(sacc + 2 * i, add_op);
      sum[i] += __shfl_xor_sync(kFullMask, sum[i], 1);
      sum[i] += __shfl_xor_sync(kFullMask, sum[i], 2);
      corr[i] = fast_exp2(fmaf(m[i], scale_log2, -mc[i]));
      l[i] = l[i] * corr[i] + sum[i];
      m[i] = mx[i];
    }
  };
  // the diagonal tile and the ragged last tile need the mask
  auto softmax_tile = [&](unsigned t, float* corr) {
    const bool masked = (int)((t + 1) * BK) > sk ||
                        (causal && (int)((t + 1) * BK) - 1 > q_offset + qw);
    if (masked) softmax(std::true_type(), t, corr);
    else softmax(std::false_type(), t, corr);
  };
  // P as A fragments: slice kk is the score columns 16 kk .. 16 kk + 15,
  // i.e. registers 8 kk .. 8 kk + 7 in pairs
  auto split_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(sacc[8 * kk + 2 * i], sacc[8 * kk + 2 * i + 1], phi[kk][i],
                   plo[kk][i]);
  };
  // the pending P.V is done: its registers and stage are free
  auto pv_done = [&](unsigned t) {
#pragma unroll
    for (int i = 0; i < NO; ++i) fence_regs(oacc[i]);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        fence_regs(phi[kk][i]);
        fence_regs(plo[kk][i]);
      }
    release(t);
  };

  mbar_wait(bar_q, 0);
  if (my_tiles > 0) {
    float corr[2];
    wait_full(0);
    issue_qk(0);
    wgmma_wait<0>();
    softmax_tile(0, corr);
    split_p();
    // tile t's Q.K^T runs on the tensor cores beside tile t - 1's P.V, and
    // its softmax beside that P.V
    for (unsigned t = 1; t < (unsigned)my_tiles; ++t) {
      wait_full(t);
      issue_qk(t);
      issue_pv(t - 1);
      wgmma_wait<1>();
      softmax_tile(t, corr);
      wgmma_wait<0>();
      pv_done(t - 1);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= corr[e >> 1];
      split_p();
    }
    wgmma_fence();
    issue_pv(my_tiles - 1);
    wgmma_wait<0>();
    pv_done(my_tiles - 1);
  }
  // the other warpgroup's tiles: the stage is released once loaded, so
  // every release of a stage follows the one before it
  for (unsigned t = my_tiles; t < (unsigned)n_tiles; ++t) {
    wait_full(t);
    release(t);
  }

  // O / max(l, 1e-30) in bf16, rows past Sq dropped
  const long long rs = (long long)n_heads * HD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + r + 8 * i;
    if (row >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane % 4 == 0)
      lse[((long long)b * n_heads + h) * sq + row] =
          (m[i] * scale_log2 + log2f(den)) * 0.69314718055994531f;
    __nv_bfloat16* orow = o + ((long long)b * sq + row) * rs + (long long)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const __nv_bfloat162 x = __floats2bfloat162_rn(
          oacc[4 * j + 2 * i] / den, oacc[4 * j + 2 * i + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) = x;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Tc<HD>::THREADS, 1) flash_attention_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int n_heads, int n_kv, int sq, int sk,
    int causal, int q_offset, float scale_log2) {
  using C = Tc<HD>;
  constexpr int BK = C::BK, CW = C::CW, NCH = C::NCH, SWB = C::SWB;
  extern __shared__ uint8_t smem_raw[];
  // every tile starts on a 1 KB boundary (the swizzle repeats every 1 KB)
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  const uint32_t s_k0 = base + C::Q_BYTES;  // stage s: K, then V
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_f0 = bar_q + 8;             // kStages full (K and V)
  const uint32_t bar_e0 = bar_f0 + 8 * kStages;  // kStages empty

  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::TQ;
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads;
  const int hk = h % n_kv;
  const int n_tiles = (kv_end(q0 + C::TQ, sq, sk, causal, q_offset) + BK - 1) /
                      BK;
  // the warp index, broadcast so the compiler knows it is warp-uniform
  const int warp = __shfl_sync(kFullMask, threadIdx.x / 32, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_f0 + 8 * s, 1);
      mbar_init(bar_e0 + 8 * s, C::CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::CONSUMERS / 32) {  // the producer warpgroup: one lane loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 ::"n"(C::PRODUCER_REGS));
    if (threadIdx.x == C::CONSUMERS) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int c = 0; c < NCH; ++c)
        tma_load(s_q + c * C::TQ * SWB, &tm_q, bar_q, c * CW, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_e0 + 8 * s, ((t / kStages) & 1) ^ 1);
        const uint32_t sk_t = s_k0 + s * 2 * C::KV_BYTES;
        const uint32_t sv_t = sk_t + C::KV_BYTES;
        mbar_expect_tx(bar_f0 + 8 * s, 2 * C::KV_BYTES);
        for (int c = 0; c < NCH; ++c) {
          tma_load(sk_t + c * BK * SWB, &tm_k, bar_f0 + 8 * s, c * CW, hk,
                   t * BK, b);
          tma_load(sv_t + c * BK * SWB, &tm_v, bar_f0 + 8 * s, c * CW, hk,
                   t * BK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 ::"n"(C::CONSUMER_REGS));
    consumer<HD>(o, lse, s_q, s_k0, bar_q, bar_f0, bar_e0, n_heads, sq, sk,
                 causal, q_offset, scale_log2, q0, b, h, n_tiles);
  }
}

template <int HD>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int h, int n_kv, int sq, int sk,
                     int causal, int q_offset, cudaStream_t stream) {
  using C = Tc<HD>;
  // TMA takes 16-byte aligned bases
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, b, sq, h, HD, C::CW, C::TQ);
  if (!e) e = make_map(&tk, k, b, sk, n_kv, HD, C::CW, C::BK);
  if (!e) e = make_map(&tv, v, b, sk, n_kv, HD, C::CW, C::BK);
  if (e) return e;
  auto kernel = flash_attention_fwd_tc_kernel<HD>;
  static bool opted_in[kMaxDevices] = {};
  e = opt_in_smem(kernel, C::SMEM, opted_in);
  if (e) return e;
  const dim3 grid(b * h, (sq + C::TQ - 1) / C::TQ);
  // the scores in log2 units: exp(s - m) = exp2((s - m) log2(e))
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)(HD)));
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, h, n_kv, sq, sk, causal, q_offset,
      scale_log2);
  return (int)cudaGetLastError();
}

// lse: null, or an fp32 (B, H, Sq) buffer for each row's log-sum-exp
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse_buf,
                                   int b, int h, int n_kv, int sq, int sk,
                                   int hd, int bf16, int causal, int q_offset,
                                   cudaStream_t stream) {
  if (n_kv <= 0 || h % n_kv) return (int)cudaErrorInvalidValue;
  float* lse = (float*)lse_buf;
  if (bf16) {  // grid (b * h, q tiles of 128 rows)
    if ((sq + 127) / 128 > 65535) return (int)cudaErrorInvalidValue;
    switch (hd) {
      case 32: return launch_tc<32>(q, k, v, o, lse, b, h, n_kv, sq, sk, causal, q_offset, stream);
      case 64: return launch_tc<64>(q, k, v, o, lse, b, h, n_kv, sq, sk, causal, q_offset, stream);
      case 128: return launch_tc<128>(q, k, v, o, lse, b, h, n_kv, sq, sk, causal, q_offset, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (b * h > 65535) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32: return launch_f32<32>(q, k, v, o, lse, b, h, n_kv, sq, sk, causal, q_offset, stream);
    case 64: return launch_f32<64>(q, k, v, o, lse, b, h, n_kv, sq, sk, causal, q_offset, stream);
    case 128: return launch_f32<128>(q, k, v, o, lse, b, h, n_kv, sq, sk, causal, q_offset, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
