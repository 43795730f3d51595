// The PPO ActorCritic's conv trunk, forward and backward, as four kernels of
// one library.
//
// The trunk (marlsnake_torch/models/ppo.py, ActorCritic.features): NHWC obs
// (uint8 or float32) -> float32 (divided by 255 where a device flag says so)
// -> conv1 3x3 SAME + bias -> ReLU -> 2x2 max pool -> conv2 3x3 SAME + bias
// -> ReLU -> 2x2 max pool -> the average pool whose window is
// (max(h2 // 2, 1), max(w2 // 2, 1)) of what is left, cropped to 2x2 -> the
// features flattened in NHWC order. It replaces XLA's fused code of the JAX
// package's ActorCritic (marlsnake_tpu/models/ppo.py:25, no Pallas kernel),
// which the port first ran as cuDNN convolutions, NHWC max pools and
// elementwise kernels. Its plain version, used on CPU tensors, is
// marlsnake_torch/ops/ppo_trunk.py::trunk_plain.
//
// trunk_forward_kernel: the features of a batch. The backward (no gradient
// for the obs): trunk_pool1_grad_kernel, the gradient of the pooled conv1
// map; trunk_weight_grads_kernel, both convolutions' weight and bias
// gradients, one partial sum a block pair; trunk_reduce_kernel sums the
// partials in block order.
//
// What bounds it on an H100: float32 multiply-adds on the CUDA cores (the
// configuration runs float32 with TF32 off: no tensor core). At 20x20 with 8
// input planes the cells the features need take 2.67 MFLOP a row forward,
// the obs 3,200 bytes a row: ~830 FLOP a byte, far above the card's 20 FLOP
// a byte of float32 at 67 TFLOP/s over 3.35 TB/s. The backward needs 0.96
// MFLOP a row (each pool passes a window's gradient to one cell of four)
// and 17 KB, plus the pool-1 gradient's 10 KB out and in again. So the
// design keeps every map on chip and spends its instructions on FFMA. What
// stands in the backward's way: the SM's shared-memory pipe delivers 128
// bytes a cycle, a float to each of a warp's lanes, against four warps'
// FFMA, so a loop that loads a float for each multiply-add runs at a
// quarter of the FFMA rate at most (a 16-byte load costs four cycles even
// where the lanes read only a few distinct addresses); and the pools' codes
// choose which cell a window's gradient reaches, so a warp whose lanes
// share a code takes a branch for each (channel, window), while lanes that
// do not share one must load what their code names.
// - Every product is an explicit fmaf: the library is built with
//   -fmad=false, which keeps K1's arithmetic exact but would split a * b + c
//   into two instructions.
// - Forward: persistent blocks (one an SM) walk over tiles of S rows. A
//   block keeps both convolutions' weights in shared memory for the whole
//   launch, laid out [input channel][tap][output channel], so that a warp
//   whose threads share a group of output channels reads 4 of them with one
//   broadcast 16-byte load. A tile's obs are read once, converted (the
//   uint8 cast is fused) and stored as zero-padded float planes in shared
//   memory; conv1's map, its pooled map and conv2's pooled map live in
//   shared memory only. A thread computes one 2x2 pool window of a group of
//   output channels (conv_block): the window's 4x4 input patch of one
//   channel in 16 registers, then 9 taps x 4 positions x CG channels of
//   FFMA from registers. It adds the bias, keeps the maximum and its
//   position (the first maximum in row-major order wins, with >, as
//   F.max_pool2d breaks ties, which one-hot boards make common), applies
//   ReLU and writes the pooled value only. Only the cells the output needs
//   are computed: conv2 only inside the average pool's cropped windows (at
//   20x20 its 4x4 of 5x5 pooled cells), conv1 only where conv2 reads (9x9
//   of 10x10 pooled cells).
// - Where autograd needs it, the forward also writes, per row, the pooled
//   conv1 map of the needed cells (float32) and both pools' codes (a byte a
//   pooled cell: 0 where the ReLU left no gradient, else 1 + the window
//   position of the maximum). The backward reads those and re-reads the obs
//   instead of recomputing the forward.
// - Backward, the gradient of the pooled conv1 map (trunk_pool1_grad_kernel,
//   a warp a row, a lane an input channel of conv2): each open pool-2
//   window adds its gradient times conv2's weights at the 3x3 taps of the
//   cell its code names. The code is the same for every lane, so the warp
//   takes one branch; a block of 2x2 windows keeps its 6x6 pool-1 cells in
//   registers while the warp walks the 32 output channels, so a lane's 9
//   weights are loaded once for 4 windows (up to 36 FFMA), and three blocks
//   an SM hide the branches. The result goes to device memory, (B, UH1 *
//   UW1, 32), 10 KB a row.
// - Backward, the weight gradients (trunk_weight_grads_kernel): a pair of
//   persistent blocks an SM, one for each convolution, each walking tiles
//   of rows whose inputs load by cp.async into one of two stages while the
//   other is worked. conv1's (w1_grad_block, through pool 1's codes against
//   the re-read obs): a lane is an output channel and reads the cell its
//   own code names, the obs laid out cell by cell (b_csx floats, the cell
//   and row strides chosen so that the four cells of a window start in
//   distinct banks), 8 channels of a tap in two 16-byte loads for 8 FFMA;
//   it is bound by those loads. conv2's (w2_grad_block, through pool 2's
//   codes against the saved pooled conv1 map): a lane is an input channel,
//   a warp owns 8 output channels, a window's 4x4 patch of the lane's plane
//   is loaded once (16 loads) and serves all 8 from registers by a switch
//   the whole warp takes (up to 72 FFMA); it is bound by its issue. In one
//   launch each fills the other's stalls. A warp holds the gradient of 8
//   channels x 9 taps in registers for the whole launch; at two blocks an
//   SM a thread has 128 registers, which hold those 72 sums and a window's
//   operands without spilling where the planes are in shared memory.
// - Nothing is added atomically and every sum has a fixed order: a block's
//   warps add their sums into its partial in warp order, and
//   trunk_reduce_kernel adds the partials in block order. Two calls give the
//   same bits.
// - A row whose planes do not fit one block's shared memory keeps them in
//   its block's region of a scratch buffer in device memory instead (GLOBAL:
//   `scratch`, `scratch2`, a row a tile), where L1 and L2 hold them; the
//   forward's weights stay in shared memory. The code is the same; the
//   copies are plain loads and stores there, as cp.async writes shared
//   memory only.
// - The kernels allocate nothing, never synchronise and launch on the
//   caller's stream, so a CUDA graph captures them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

// Mirror of ops/ppo_trunk.py::_TrunkArgs. Offsets and strides are in floats
// unless they say bytes.
struct TrunkArgs {
  const void* x;           // (B, H, W, Cin) uint8 or float32, contiguous
  const uint8_t* divide;   // x / 255 where *divide != 0; null: never
  const float* w1;         // (32, Cin, 3, 3)
  const float* b1;         // (32,)
  const float* w2;         // (32, 32, 3, 3)
  const float* b2;         // (32,)
  float* feats;            // (B, PH * PW * 32)
  float* p1;               // (B, 32, UH1, UW1) or null
  uint8_t* code1;          // (B, 32, UH1, UW1) or null
  uint8_t* code2;          // (B, 32, UH2, UW2) or null
  const float* gfeats;     // (B, PH * PW * 32): the features' gradient
  float* dp1;              // (B, UH1 * UW1, 32): the pooled conv1 map's
  float* partial;          // (grid, nw)
  float* grads;            // (nw,): dw1, db1, dw2, db2, flat
  float* scratch;          // (grid, S * ss) where a row's planes do not
                           // fit shared memory; null: they live there
  float* scratch2;         // the same for conv2's weight gradient
  int B, H, W, Cin;
  int UH1, UW1, UH2, UW2;  // pooled cells computed after pool 1 and pool 2
  int WH, WW, PH, PW;      // average pool window and output cells
  int XH, XW, P1H, P1W;    // padded planes: obs, pool 1
  int S, S2, nw, vec4;     // rows a tile (S2: conv2's weight gradient)
  int f_w1, f_b1, f_w2, f_b2, f_samples, f_ss, f_x, f_p1, f_p2;
  int w1_ss, w1_x, w1_st, w1_raw, w1_d, w1_c1;  // conv1's weight gradient
  int w2_head, w2_ss, w2_st, w2_p1, w2_g2, w2_c2, w2_ct;  // conv2's
  int b_p1w, b_p1pp;   // pool 1's padded planes: cells a row, floats a plane
  int b_xw, b_csx;     // the obs' padded cells: cells a row, floats a cell
};

namespace {

constexpr int kC = 32;            // output channels of both convolutions
constexpr int kThreads = 512;     // the forward's block: 16 warps
constexpr int kCG1 = 8;           // output channels a thread: conv1
constexpr int kCG2 = 4;           // conv2
constexpr int kBwdThreads = 256;  // the backward's blocks: 8 warps
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kMaxCin = 64;       // input channels the backward takes
constexpr int kWin = 2;           // pool-1 gradient: 2x2 pool-2 windows a
constexpr int kRegion = 2 * kWin + 2;  // block, 6x6 pool-1 cells
constexpr int kPool1Blocks = 3;   // ... and 3 blocks an SM
// a warp's codes and gradients of a block's windows, in floats
constexpr int kPool1WarpFloats = kC * kWin * kWin / 4 + kC * kWin * kWin;
constexpr int kGroup = 8;         // weight gradients: input channels a warp

__device__ __forceinline__ float to_float(uint8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }

__device__ __forceinline__ float obs_value(float v, bool divide) {
  return divide ? __fdiv_rn(v, 255.0f) : v;
}

// One input channel's share of a 2x2 block of outputs of CG channels: `in`
// points at the block's padded origin (the input cell up-left of its first
// output), `rs` is the row stride, `w` the channel's [tap][32] weights from
// the block's first output channel.
template <int CG>
__device__ __forceinline__ void conv_step(const float* in,
                                          int rs,
                                          const float* __restrict__ w,
                                          float (&acc)[4][CG]) {
  float v[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 lo = *reinterpret_cast<const float2*>(in + r * rs);
    const float2 hi = *reinterpret_cast<const float2*>(in + r * rs + 2);
    v[r][0] = lo.x;
    v[r][1] = lo.y;
    v[r][2] = hi.x;
    v[r][3] = hi.y;
  }
#pragma unroll
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap % 3;
    float wv[CG];
#pragma unroll
    for (int c = 0; c < CG; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + tap * kC + c);
      wv[c] = q.x;
      wv[c + 1] = q.y;
      wv[c + 2] = q.z;
      wv[c + 3] = q.w;
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
#pragma unroll
      for (int c = 0; c < CG; ++c) {
        acc[d][c] = fmaf(v[(d >> 1) + ky][(d & 1) + kx], wv[c], acc[d][c]);
      }
    }
  }
}

// A 2x2 block of outputs of CG channels over `cin` padded planes of stride
// `plane`; the sum runs over the input channels, then the taps.
template <int CG>
__device__ __forceinline__ void conv_block(const float* in,
                                           int plane, int rs, int cin,
                                           const float* __restrict__ w,
                                           float (&acc)[4][CG]) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
#pragma unroll
    for (int c = 0; c < CG; ++c) acc[d][c] = 0.0f;
  }
#pragma unroll 2
  for (int ci = 0; ci < cin; ++ci) {
    conv_step<CG>(in + ci * plane, rs, w + ci * 9 * kC, acc);
  }
}

// Bias, 2x2 max pool and ReLU of a block: the pooled value and its code (0
// where the maximum is not above 0, so no gradient passes; else 1 + the
// position of the first maximum in row-major order).
template <int CG>
__device__ __forceinline__ void pool_block(const float (&acc)[4][CG],
                                           const float* __restrict__ bias,
                                           float (&val)[CG],
                                           uint8_t (&code)[CG]) {
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    float best = acc[0][c] + bias[c];
    int at = 0;
#pragma unroll
    for (int d = 1; d < 4; ++d) {
      const float v = acc[d][c] + bias[c];
      if (v > best || isnan(v)) {
        best = v;
        at = d;
      }
    }
    const bool pass = best > 0.0f;
    val[c] = pass || isnan(best) ? best : 0.0f;
    code[c] = pass ? static_cast<uint8_t>(at + 1) : 0;
  }
}

// store(i, j, load(i, j)) for i < n_inner, j < n_outer. Where the block's
// threads cover n_inner, each takes one i and every per-th j, so that it
// decodes i once; its K loads are in flight before its first store, so a
// fill waits on device memory once a round, not once an element.
template <int K, typename Load, typename Store>
__device__ __forceinline__ void copy_2d(int n_inner, int n_outer, Load load,
                                        Store store) {
  const int nt = blockDim.x;
  const bool covered = n_inner <= nt;
  const int per = covered ? nt / n_inner : 1;
  const int j0 = covered ? threadIdx.x / n_inner : 0;
  if (j0 >= per) return;
  for (int i = covered ? threadIdx.x % n_inner : threadIdx.x; i < n_inner;
       i += nt) {
    for (int jb = j0; jb < n_outer; jb += K * per) {
      decltype(load(0, 0)) v[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = jb + k * per;
        if (j < n_outer) v[k] = load(i, j);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = jb + k * per;
        if (j < n_outer) store(i, j, v[k]);
      }
    }
  }
}

__device__ __forceinline__ float4 load4(const uint8_t* p) {
  const uchar4 q = *reinterpret_cast<const uchar4*>(p);
  return make_float4(q.x, q.y, q.z, q.w);
}
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 4 bytes from device memory to shared memory, asynchronously: a thread
// issues all of a tile's copies and waits once (cp.async.wait_all).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

// The obs of rows b0 .. b0 + ns - 1 into the interiors of their padded
// planes (row stride ss, plane stride `plane`, the halo left alone), 4
// channels a load where the layout allows.
template <typename T>
__device__ __forceinline__ void fill_obs(const TrunkArgs& a, float* samples,
                                         int ss, int xo, int plane, int b0,
                                         int ns, bool divide) {
  const int hw = a.H * a.W, per = hw * a.Cin;
  const T* x = static_cast<const T*>(a.x) + static_cast<size_t>(b0) * per;
  auto cell = [&](int pix) {
    const int y = pix / a.W;
    return (y + 1) * a.XW + pix - y * a.W + 1;
  };
  if (a.vec4) {
    const int chunks = a.Cin / 4;
    copy_2d<4>(
        hw, ns * chunks,
        [&](int pix, int j) {
          const int s = j / chunks;
          return load4(x + s * per + pix * a.Cin + 4 * (j - s * chunks));
        },
        [&](int pix, int j, float4 v) {
          const int s = j / chunks;
          float* dst = samples + s * ss + xo + 4 * (j - s * chunks) * plane +
                       cell(pix);
          dst[0] = obs_value(v.x, divide);
          dst[plane] = obs_value(v.y, divide);
          dst[2 * plane] = obs_value(v.z, divide);
          dst[3 * plane] = obs_value(v.w, divide);
        });
  } else {
    copy_2d<8>(
        hw, ns * a.Cin,
        [&](int pix, int j) {
          const int s = j / a.Cin;
          return to_float(x[s * per + pix * a.Cin + j - s * a.Cin]);
        },
        [&](int pix, int j, float v) {
          const int s = j / a.Cin;
          samples[s * ss + xo + (j - s * a.Cin) * plane + cell(pix)] =
              obs_value(v, divide);
        });
  }
}

template <typename T, bool SAVE, bool GLOBAL>
__global__ void __launch_bounds__(kThreads, 1)
    trunk_forward_kernel(const TrunkArgs a) {
  extern __shared__ float4 smem_raw[];
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* w1s = sm + a.f_w1;
  float* b1s = sm + a.f_b1;
  float* w2s = sm + a.f_w2;
  float* b2s = sm + a.f_b2;
  float* samples =
      GLOBAL ? a.scratch + static_cast<size_t>(blockIdx.x) * a.S * a.f_ss
             : sm + a.f_samples;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < a.Cin * 9 * kC; i += nt) {
    const int co = i % kC, ct = i / kC, ci = ct / 9, tap = ct - ci * 9;
    w1s[i] = a.w1[(co * a.Cin + ci) * 9 + tap];
  }
  for (int i = tid; i < kC * 9 * kC; i += nt) {
    const int co = i % kC, ct = i / kC, ci = ct / 9, tap = ct - ci * 9;
    w2s[i] = a.w2[(co * kC + ci) * 9 + tap];
  }
  if (tid < kC) {
    b1s[tid] = a.b1[tid];
    b2s[tid] = a.b2[tid];
  }
  // the halos are zero from here on: later writes fill interiors only
  for (int i = tid; i < a.S * a.f_ss; i += nt) samples[i] = 0.0f;
  const bool divide = a.divide != nullptr && *a.divide != 0;
  __syncthreads();

  const int tiles = (a.B + a.S - 1) / a.S;
  const int xplane = a.XH * a.XW, p1plane = a.P1H * a.P1W;
  const int nq1 = a.UH1 * a.UW1, nq2 = a.UH2 * a.UW2;
  const int nf = a.PH * a.PW * kC;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b0 = tile * a.S, ns = min(a.S, a.B - b0);
    fill_obs<T>(a, samples, a.f_ss, a.f_x, xplane, b0, ns, divide);
    __syncthreads();

    // conv1, bias, ReLU, pool 1 into the padded pool-1 planes
    {
      const int per_g = ns * nq1, n = per_g * (kC / kCG1);
      for (int t = tid; t < n; t += nt) {
        const int g = t / per_g, r = t - g * per_g;
        const int s = r / nq1, q = r - s * nq1;
        const int qy = q / a.UW1, qx = q - qy * a.UW1;
        float* smp = samples + s * a.f_ss;
        float acc[4][kCG1];
        conv_block<kCG1>(smp + a.f_x + 2 * qy * a.XW + 2 * qx, xplane, a.XW,
                         a.Cin, w1s + g * kCG1, acc);
        float val[kCG1];
        uint8_t code[kCG1];
        pool_block<kCG1>(acc, b1s + g * kCG1, val, code);
#pragma unroll
        for (int c = 0; c < kCG1; ++c) {
          const int ch = g * kCG1 + c;
          smp[a.f_p1 + ch * p1plane + (qy + 1) * a.P1W + qx + 1] = val[c];
          if (SAVE) {
            const size_t o =
                (static_cast<size_t>(b0 + s) * kC + ch) * nq1 + q;
            a.p1[o] = val[c];
            a.code1[o] = code[c];
          }
        }
      }
    }
    __syncthreads();

    // conv2, bias, ReLU, pool 2 over the cells the average pool reads
    {
      const int per_g = ns * nq2, n = per_g * (kC / kCG2);
      for (int t = tid; t < n; t += nt) {
        const int g = t / per_g, r = t - g * per_g;
        const int s = r / nq2, q = r - s * nq2;
        const int qy = q / a.UW2, qx = q - qy * a.UW2;
        float* smp = samples + s * a.f_ss;
        float acc[4][kCG2];
        conv_block<kCG2>(smp + a.f_p1 + 2 * qy * a.P1W + 2 * qx, p1plane,
                         a.P1W, kC, w2s + g * kCG2, acc);
        float val[kCG2];
        uint8_t code[kCG2];
        pool_block<kCG2>(acc, b2s + g * kCG2, val, code);
#pragma unroll
        for (int c = 0; c < kCG2; ++c) {
          const int ch = g * kCG2 + c;
          smp[a.f_p2 + ch * nq2 + q] = val[c];
          if (SAVE) {
            a.code2[(static_cast<size_t>(b0 + s) * kC + ch) * nq2 + q] =
                code[c];
          }
        }
      }
    }
    __syncthreads();

    // the average pool, cropped, flattened in NHWC order
    {
      const float count = static_cast<float>(a.WH * a.WW);
      for (int t = tid; t < ns * nf; t += nt) {
        const int s = t / nf, f = t - s * nf;
        const int c = f % kC, cell = f / kC;
        const int py = cell / a.PW, px = cell - py * a.PW;
        const float* p2 = samples + s * a.f_ss + a.f_p2 + c * nq2 +
                          py * a.WH * a.UW2 + px * a.WW;
        float sum = 0.0f;
        for (int i = 0; i < a.WH; ++i) {
          for (int j = 0; j < a.WW; ++j) sum += p2[i * a.UW2 + j];
        }
        a.feats[static_cast<size_t>(b0) * nf + t] = __fdiv_rn(sum, count);
      }
    }
    __syncthreads();
  }
}

// 16 bytes from device memory to shared memory, asynchronously.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's latest groups of copies are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 4 or 16 bytes from device memory into a tile's planes: asynchronously
// where they are in shared memory, by a plain load and store where not.
template <bool GLOBAL>
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  if (GLOBAL) {
    *static_cast<uint32_t*>(dst) = *static_cast<const uint32_t*>(src);
  } else {
    cp_async4(dst, src);
  }
}

template <bool GLOBAL>
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  if (GLOBAL) {
    *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
  } else {
    cp_async16(dst, src);
  }
}

// --- the pool-1 gradient: trunk_pool1_grad_kernel ---------------------------

// Adds g * w[tap] to a region of pool-1 cells at the 3x3 taps whose first
// cell is (DY, DX).
template <int DY, int DX>
__device__ __forceinline__ void add_taps(float (&r)[kRegion][kRegion],
                                         float g, const float (&w)[9]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    r[DY + k / 3][DX + k % 3] = fmaf(g, w[k], r[DY + k / 3][DX + k % 3]);
  }
}

// Window I of a block (row I / kWin, column I % kWin): its gradient at the
// cell its code names (byte I % 4 of `codes`), times the weights.
template <int I>
__device__ __forceinline__ void add_window(float (&r)[kRegion][kRegion],
                                           uint32_t codes, float g,
                                           const float (&w)[9]) {
  constexpr int oy = 2 * (I / kWin), ox = 2 * (I % kWin);
  switch ((codes >> (8 * (I % 4))) & 0xffu) {
    case 0: break;
    case 1: add_taps<oy, ox>(r, g, w); break;
    case 2: add_taps<oy, ox + 1>(r, g, w); break;
    case 3: add_taps<oy + 1, ox>(r, g, w); break;
    default: add_taps<oy + 1, ox + 1>(r, g, w); break;
  }
}

template <int... I>
__device__ __forceinline__ void add_windows(
    float (&r)[kRegion][kRegion], const uint32_t (&codes)[kWin * kWin / 4],
    const float (&g)[kWin * kWin], const float (&w)[9],
    std::integer_sequence<int, I...>) {
  (add_window<I>(r, codes[I / 4], g[I], w), ...);
}

// The gradient of the pooled conv1 map, (B, UH1 * UW1, 32), from the
// features' gradient through pool 2's codes: a warp a row, a lane one of
// conv2's input channels. A row's pool-2 windows go in blocks of kWin x
// kWin, in row-major order; a block's pool-1 cells stay in registers while
// the warp walks conv2's 32 output channels, each channel's 9 weights of
// the lane loaded once for the block's windows. A window's code is the
// same on every lane, so the warp takes one branch of its switch; the
// small block leaves room for kPool1Blocks blocks an SM, whose warps fill
// the branches' bubbles. Cells two blocks share are added to what the
// first wrote, by the same lane: every sum has a fixed order.
__global__ void __launch_bounds__(kBwdThreads, kPool1Blocks)
    trunk_pool1_grad_kernel(const TrunkArgs a) {
  extern __shared__ float4 smem_raw[];
  float* w2s = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // this warp's codes (a byte each) and gradients of a block's windows,
  // [output channel][window]
  uint8_t* wcodes = reinterpret_cast<uint8_t*>(
      w2s + kC * 9 * kC + warp * kPool1WarpFloats);
  float* wg = w2s + kC * 9 * kC + warp * kPool1WarpFloats +
             kC * kWin * kWin / 4;
  // conv2's weights as [co][tap][ci]: a lane reads its input channel's
  for (int i = tid; i < kC * 9 * kC; i += kBwdThreads) {
    const int ci = i % kC, ct = i / kC, co = ct / 9, tap = ct - co * 9;
    w2s[i] = a.w2[(co * kC + ci) * 9 + tap];
  }
  __syncthreads();

  const int nq1 = a.UH1 * a.UW1, nq2 = a.UH2 * a.UW2;
  const int nf = a.PH * a.PW * kC;
  const float count = static_cast<float>(a.WH * a.WW);
  const int nby = (a.UH2 + kWin - 1) / kWin, nbx = (a.UW2 + kWin - 1) / kWin;
  for (int b = blockIdx.x * kBwdWarps + warp; b < a.B;
       b += gridDim.x * kBwdWarps) {
    const uint8_t* code2 = a.code2 + static_cast<size_t>(b) * kC * nq2;
    const float* gf = a.gfeats + static_cast<size_t>(b) * nf;
    float* dp1 = a.dp1 + static_cast<size_t>(b) * nq1 * kC + lane;
    for (int by = 0; by < nby; ++by) {
      for (int bx = 0; bx < nbx; ++bx) {
        // lane co: its code and gradient (the features' over the window's
        // size) at each window of the block; 0 where there is none
#pragma unroll
        for (int i = 0; i < kWin * kWin; ++i) {
          const int qy = by * kWin + i / kWin, qx = bx * kWin + i % kWin;
          int code = 0;
          float g = 0.0f;
          if (qy < a.UH2 && qx < a.UW2) {
            code = code2[lane * nq2 + qy * a.UW2 + qx];
            if (code) {
              g = __fdiv_rn(gf[((qy / a.WH) * a.PW + qx / a.WW) * kC + lane],
                            count);
            }
          }
          wcodes[lane * kWin * kWin + i] = static_cast<uint8_t>(code);
          wg[lane * kWin * kWin + i] = g;
        }
        __syncwarp();
        float r[kRegion][kRegion];
#pragma unroll
        for (int y = 0; y < kRegion; ++y) {
#pragma unroll
          for (int x = 0; x < kRegion; ++x) r[y][x] = 0.0f;
        }
#pragma unroll 1
        for (int co = 0; co < kC; ++co) {
          float w[9];
#pragma unroll
          for (int k = 0; k < 9; ++k) w[k] = w2s[(co * 9 + k) * kC + lane];
          uint32_t codes[kWin * kWin / 4];
          float g[kWin * kWin];
#pragma unroll
          for (int j = 0; j < kWin * kWin / 4; ++j) {
            codes[j] = reinterpret_cast<const uint32_t*>(
                wcodes + co * kWin * kWin)[j];
            const float4 v = *reinterpret_cast<const float4*>(
                wg + co * kWin * kWin + 4 * j);
            g[4 * j] = v.x;
            g[4 * j + 1] = v.y;
            g[4 * j + 2] = v.z;
            g[4 * j + 3] = v.w;
          }
          add_windows(r, codes, g, w,
                      std::make_integer_sequence<int, kWin * kWin>{});
        }
        __syncwarp();
        // the region's cells that exist; those an earlier block of the row
        // wrote (its last two rows or columns) are added to
        const int y0 = 2 * kWin * by - 1, x0 = 2 * kWin * bx - 1;
#pragma unroll
        for (int ly = 0; ly < kRegion; ++ly) {
#pragma unroll
          for (int lx = 0; lx < kRegion; ++lx) {
            const int y = y0 + ly, x = x0 + lx;
            if (y >= 0 && y < a.UH1 && x >= 0 && x < a.UW1) {
              float* d = dp1 + (y * a.UW1 + x) * kC;
              const bool again = (by > 0 && ly < 2) || (bx > 0 && lx < 2);
              *d = again ? *d + r[ly][lx] : r[ly][lx];
            }
          }
        }
      }
    }
  }
}

// --- the weight gradients: trunk_weight_grads_kernel ------------------------

// i / n by a multiply, exact for i * n < 2^32: inv is inverse(n),
// 2^32 / n rounded up, and 0 for n = 1 (where 2^32 does not fit).
__device__ __forceinline__ uint32_t inverse(int n) {
  return n > 1 ? static_cast<uint32_t>(((1ull << 32) + n - 1) / n) : 0u;
}

__device__ __forceinline__ int divide(int i, int n, uint32_t inv) {
  return n > 1 ? static_cast<int>(__umulhi(static_cast<uint32_t>(i), inv))
               : i;
}

// acc[j][k] += g * the input at tap k of channel j, for the 8 channels of
// a group, at the cell of a 2x2 window that its pool code names. `in`
// points at channel 0 of the group in the padded cell up-left of the
// window's first cell; a cell holds `cs` floats, a row `rw` cells. g is 0
// where the code is: the window's first cell is then read and adds 0.
__device__ __forceinline__ void route_window(const float* in, int cs, int rw,
                                             int code, float g,
                                             float (&acc)[kGroup][9]) {
  const int at = max(code - 1, 0);
  const float* p = in + ((at >> 1) * rw + (at & 1)) * cs;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float* c = p + ((k / 3) * rw + k % 3) * cs;
    const float4 u = *reinterpret_cast<const float4*>(c);
    const float4 v = *reinterpret_cast<const float4*>(c + 4);
    acc[0][k] = fmaf(g, u.x, acc[0][k]);
    acc[1][k] = fmaf(g, u.y, acc[1][k]);
    acc[2][k] = fmaf(g, u.z, acc[2][k]);
    acc[3][k] = fmaf(g, u.w, acc[3][k]);
    acc[4][k] = fmaf(g, v.x, acc[4][k]);
    acc[5][k] = fmaf(g, v.y, acc[5][k]);
    acc[6][k] = fmaf(g, v.z, acc[6][k]);
    acc[7][k] = fmaf(g, v.w, acc[7][k]);
  }
}

// One convolution's weight gradient over a tile of ns rows: the lane is an
// output channel; its windows (row s, window q of nq, uw a row), items
// first, first + step, ... of the tile, each add the window's gradient
// (`gs`: [cell][channel], the cell gcell[q], or q where gcell is null)
// times the input patch (`in`, the group's first channel at padded cell 0)
// of the cell its code names (`codes`: `cstride` bytes a channel) to the
// group's accumulators. Rows are `in_ss`, `code_ss` and `g_ss` floats
// apart. The loop has no branch but its own: a window's row comes by a
// multiply (divide, uw_inv = inverse(uw)), and an item's code and gradient
// are loaded, from a window clamped into the row, while the one before
// adds, so that their latency hides behind its multiply-adds.
__device__ __forceinline__ void weight_grad_items(
    const float* in, int in_ss, int cs, int rw, const float* codes,
    int code_ss, int cstride, const float* gs, int g_ss,
    const uint8_t* gcell, int ns, int nq, int uw, uint32_t uw_inv,
    int first, int step, float (&acc)[kGroup][9], float& bias) {
  const int lane = threadIdx.x % 32;
  int q = first;
  for (int s = 0; s < ns; ++s, q -= nq) {
    const float* x = in + s * in_ss;
    const uint8_t* code_of =
        reinterpret_cast<const uint8_t*>(codes + s * code_ss) + lane * cstride;
    const float* g_of = gs + s * g_ss + lane;
    auto gradient = [&](int w, int code) {
      return code ? g_of[(gcell ? gcell[w] : w) * kC] : 0.0f;
    };
    int code = code_of[min(q, nq - 1)];
    float g = gradient(min(q, nq - 1), code);
    for (; q < nq; q += step) {
      const int next = min(q + step, nq - 1);
      const int next_code = code_of[next];
      const float next_g = gradient(next, next_code);
      const int qy = divide(q, uw, uw_inv), qx = q - qy * uw;
      route_window(x + (2 * qy * rw + 2 * qx) * cs, cs, rw, code, g, acc);
      bias += g;
      code = next_code;
      g = next_g;
    }
  }
}

// `bytes` (a multiple of 4) from device memory to `dst`: 16 bytes a copy
// where both ends and the count allow it, else 4.
template <bool GLOBAL>
__device__ __forceinline__ void copy_row(float* dst, const void* src,
                                         int bytes) {
  const char* from = static_cast<const char*>(src);
  const size_t ends =
      reinterpret_cast<size_t>(from) | reinterpret_cast<size_t>(dst);
  if ((ends & 15) == 0 && (bytes & 15) == 0) {
    for (int i = threadIdx.x; i < bytes / 16; i += kBwdThreads) {
      copy16<GLOBAL>(dst + 4 * i, from + 16 * i);
    }
  } else {
    for (int i = threadIdx.x; i < bytes / 4; i += kBwdThreads) {
      copy4<GLOBAL>(dst + i, from + 4 * i);
    }
  }
}

// A tile's obs into their padded cells (`xs`, a row `x_ss` floats), as
// float32 (divided by 255 where DIVIDE): 4 channels a 16-byte store where
// they come 4 a word, staged uint8 (`raw`, a row `raw_ss` floats apart)
// made float by placing each in the mantissa of 2^23 (exact); else one a
// store, from device memory.
template <typename T, bool DIVIDE>
__device__ __forceinline__ void convert_obs(const TrunkArgs& a, float* xs,
                                            int x_ss, const float* raw,
                                            int raw_ss, int b0, int ns,
                                            bool staged) {
  const int hw = a.H * a.W;
  auto value = [](float v) { return DIVIDE ? __fdiv_rn(v, 255.0f) : v; };
  for (int s = 0; s < ns; ++s) {
    const T* x =
        static_cast<const T*>(a.x) + static_cast<size_t>(b0 + s) * hw * a.Cin;
    float* planes = xs + s * x_ss;
    if (a.vec4) {
      const int chunks = a.Cin / 4;
      const uint32_t* words =
          reinterpret_cast<const uint32_t*>(raw + s * raw_ss);
      for (int pix = threadIdx.x; pix < hw; pix += kBwdThreads) {
        const int y = pix / a.W;
        float* dst = planes + ((y + 1) * a.b_xw + pix - y * a.W + 1) * a.b_csx;
        for (int c = 0; c < chunks; ++c) {
          float4 v;
          if (staged) {
            const uint32_t w = words[pix * chunks + c];
            v = make_float4(
                __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7540)) -
                    8388608.0f,
                __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7541)) -
                    8388608.0f,
                __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7542)) -
                    8388608.0f,
                __uint_as_float(__byte_perm(w, 0x4b000000u, 0x7543)) -
                    8388608.0f);
          } else {
            v = load4(x + pix * a.Cin + 4 * c);
          }
          *reinterpret_cast<float4*>(dst + 4 * c) =
              make_float4(value(v.x), value(v.y), value(v.z), value(v.w));
        }
      }
    } else {
      for (int i = threadIdx.x; i < hw * a.Cin; i += kBwdThreads) {
        const int pix = i / a.Cin, y = pix / a.W;
        planes[((y + 1) * a.b_xw + pix - y * a.W + 1) * a.b_csx + i -
               pix * a.Cin] = value(to_float(x[i]));
      }
    }
  }
}

// A block's partial sums of one convolution's weight and bias gradients,
// in PyTorch's layout at `out` (cin input channels; the bias at out_bias):
// the warps of channel group `group` (w = 0, 1, ... of `per`) add theirs
// in warp order, a round each; a warp past the last share adds nothing.
__device__ __forceinline__ void write_partial(float* out, float* out_bias,
                                              int cin, int group, int w,
                                              int per,
                                              const float (&acc)[kGroup][9],
                                              float bias) {
  const int lane = threadIdx.x % 32;
  for (int r = 0; r < kBwdWarps; ++r) {
    if (w == r && w < per) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int ci = kGroup * group + j;
        if (ci < cin) {
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            float* o = out + (lane * cin + ci) * 9 + k;
            *o = r ? *o + acc[j][k] : acc[j][k];
          }
        }
      }
      if (group == 0) out_bias[lane] = r ? out_bias[lane] + bias : bias;
    }
    __syncthreads();
  }
}

// conv1's weight and bias gradients, block `block` of `blocks`' partial
// sum, from the pool-1 gradient through pool 1's codes against the re-read
// obs, over tiles of S rows. The tile's obs planes (float, a padded cell of
// b_csx floats) are made from two stages of S rows each (the raw uint8 obs
// where they come in whole words, the pool-1 gradient [cell][32], pool 1's
// codes): while one tile is worked, the next but one loads into the stage
// the last one freed. A lane is an output channel; a warp holds the
// gradient of a group of 8 input channels in registers for the whole
// launch, and each window adds its gradient times 8 channels of each tap
// of the cell its code names, two 16-byte loads for 8 FFMA. The lanes of a
// load read at most the four cells of one window, which the planes'
// strides put in distinct banks.
template <typename T, bool GLOBAL>
__device__ __forceinline__ void w1_grad_block(const TrunkArgs& a,
                                              float4* smem_raw, int block,
                                              int blocks) {
  float* xs =
      GLOBAL ? a.scratch + static_cast<size_t>(block) * a.S * a.w1_ss
             : reinterpret_cast<float*>(smem_raw);
  // two stages, a tile's chosen by a select (an array indexed at run time
  // would live in local memory)
  float* const stage0 = xs + a.S * a.w1_x;
  float* const stage1 = stage0 + a.S * a.w1_st;
  const int tid = threadIdx.x, warp = tid / 32;
  // the halos and the padding channels are zero from here on: later
  // writes fill interiors only
  for (int i = tid; i < a.S * a.w1_ss; i += kBwdThreads) xs[i] = 0.0f;
  const bool divide = a.divide != nullptr && *a.divide != 0;
  const int nq1 = a.UH1 * a.UW1, hw = a.H * a.W;
  const bool staged = sizeof(T) == 1 && a.vec4;
  const int tiles = (a.B + a.S - 1) / a.S;
  const uint32_t inv = inverse(a.UW1);
  // warp w: input-channel group w % n and share w / n of the items
  const int n = (a.Cin + kGroup - 1) / kGroup, per = kBwdWarps / n;
  const int group = warp % n, share = warp / n;
  float acc[kGroup][9], bias = 0.0f;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[j][k] = 0.0f;
  }
  __syncthreads();

  auto issue = [&](int tile, float* stage) {
    const int b0 = tile * a.S, ns = min(a.S, a.B - b0);
    for (int s = 0; s < ns; ++s) {
      const size_t b = b0 + s;
      float* st = stage + s * a.w1_st;
      copy_row<GLOBAL>(st + a.w1_d, a.dp1 + b * nq1 * kC, nq1 * kC * 4);
      copy_row<GLOBAL>(st + a.w1_c1, a.code1 + b * kC * nq1, kC * nq1);
      if (staged) {
        copy_row<GLOBAL>(st + a.w1_raw,
                         static_cast<const uint8_t*>(a.x) + b * hw * a.Cin,
                         hw * a.Cin);
      }
    }
  };
  int tile = block;
  if (tile < tiles) issue(tile, stage0);
  if (!GLOBAL) cp_async_commit();
  if (tile + blocks < tiles) issue(tile + blocks, stage1);
  if (!GLOBAL) cp_async_commit();
  for (int it = 0; tile < tiles; tile += blocks, ++it) {
    const int b0 = tile * a.S, ns = min(a.S, a.B - b0);
    float* const st = (it & 1) ? stage1 : stage0;
    if (!GLOBAL) cp_async_wait<1>();
    __syncthreads();
    if (divide) {
      convert_obs<T, true>(a, xs, a.w1_x, st + a.w1_raw, a.w1_st, b0, ns,
                           staged);
    } else {
      convert_obs<T, false>(a, xs, a.w1_x, st + a.w1_raw, a.w1_st, b0, ns,
                            staged);
    }
    __syncthreads();
    if (share < per) {
      weight_grad_items(xs + kGroup * group, a.w1_x, a.b_csx, a.b_xw,
                        st + a.w1_c1, a.w1_st, nq1, st + a.w1_d, a.w1_st,
                        nullptr, ns, nq1, a.UW1, inv, share, per, acc, bias);
    }
    __syncthreads();
    if (tile + 2 * blocks < tiles) issue(tile + 2 * blocks, st);
    if (!GLOBAL) cp_async_commit();
  }
  if (!GLOBAL) cp_async_wait<0>();
  float* out = a.partial + static_cast<size_t>(block) * a.nw;
  write_partial(out, out + kC * a.Cin * 9, a.Cin, group, share, per, acc,
                bias);
}

// acc[k] += g * the 3x3 taps whose first cell is (DY, DX) of a 4x4 patch.
template <int DY, int DX>
__device__ __forceinline__ void add_patch(float (&acc)[9], float g,
                                          const float (&p)[4][4]) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    acc[k] = fmaf(g, p[DY + k / 3][DX + k % 3], acc[k]);
  }
}

// conv2's weight and bias gradients, block `block` of `blocks`' partial
// sum, from the features' gradient through pool 2's codes against the
// saved pooled conv1 map, over tiles of S2 rows, each tile loading
// into one of two stages (the pooled conv1 map as padded planes, pool 2's
// codes, the features' gradient) while the other is worked. A lane is one
// of conv2's input channels, a warp owns a group of 8 output channels: a
// window's 4x4 patch of the lane's plane is loaded once and serves all 8
// channels from registers, each taking the 3x3 taps its code names by a
// switch that is the same on every lane (a closed window is skipped by the
// whole warp): 16 loads for up to 72 FFMA. The warps of a group take turns
// over the tile's windows.
template <bool GLOBAL>
__device__ __forceinline__ void w2_grad_block(const TrunkArgs& a,
                                              float4* smem_raw, int block,
                                              int blocks) {
  // each pool-2 window's cell of the features' gradient, then the stages
  uint8_t* gcell = reinterpret_cast<uint8_t*>(smem_raw);
  float* stage0 =
      GLOBAL ? a.scratch2 + static_cast<size_t>(block) * a.S2 * a.w2_ss
             : reinterpret_cast<float*>(smem_raw) + a.w2_head;
  float* const stage1 = stage0 + a.S2 * a.w2_st;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // the halos are zero from here on: later writes fill interiors only
  for (int i = tid; i < a.S2 * a.w2_ss; i += kBwdThreads) stage0[i] = 0.0f;
  const int nq1 = a.UH1 * a.UW1, nq2 = a.UH2 * a.UW2;
  const int nf = a.PH * a.PW * kC;
  for (int q = tid; q < nq2; q += kBwdThreads) {
    const int qy = q / a.UW2, qx = q - qy * a.UW2;
    gcell[q] = static_cast<uint8_t>((qy / a.WH) * a.PW + qx / a.WW);
  }
  const float count = static_cast<float>(a.WH * a.WW);
  const int tiles = (a.B + a.S2 - 1) / a.S2;
  // a row's window and a window's row by multiplies, exact for i * n < 2^32
  const uint32_t inv_nq = inverse(nq2), inv_uw = inverse(a.UW2);
  constexpr int n = kC / kGroup, per = kBwdWarps / n;
  const int group = warp % n, share = warp / n;
  // a lane sums the bias gradient of the group's channel lane % kGroup
  // (lanes below kGroup write it): one register, not kGroup
  const int mine = lane % kGroup;
  float acc[kGroup][9], bias = 0.0f;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
#pragma unroll
    for (int k = 0; k < 9; ++k) acc[j][k] = 0.0f;
  }
  __syncthreads();

  auto issue = [&](int tile, float* stage) {
    const int b0 = tile * a.S2, ns = min(a.S2, a.B - b0);
    // the pooled conv1 map into its padded planes: a thread decodes its
    // cell once and walks the channels of the tile's rows
    const bool covered = nq1 <= kBwdThreads;
    const int rep = covered ? kBwdThreads / nq1 : 1;
    const int j0 = covered ? tid / nq1 : 0;
    if (j0 < rep) {
      for (int q = covered ? tid % nq1 : tid; q < nq1; q += kBwdThreads) {
        const int y = q / a.UW1;
        const int cell = (y + 1) * a.b_p1w + q - y * a.UW1 + 1;
        for (int j = j0; j < ns * kC; j += rep) {
          copy4<GLOBAL>(stage + (j / kC) * a.w2_st + a.w2_p1 +
                            (j % kC) * a.b_p1pp + cell,
                        a.p1 + (static_cast<size_t>(b0) * kC + j) * nq1 + q);
        }
      }
    }
    for (int s = 0; s < ns; ++s) {
      const size_t b = b0 + s;
      float* st = stage + s * a.w2_st;
      copy_row<GLOBAL>(st + a.w2_g2, a.gfeats + b * nf, nf * 4);
      copy_row<GLOBAL>(st + a.w2_c2, a.code2 + b * kC * nq2, kC * nq2);
    }
  };
  int tile = block;
  if (tile < tiles) issue(tile, stage0);
  if (!GLOBAL) cp_async_commit();
  if (tile + blocks < tiles) issue(tile + blocks, stage1);
  if (!GLOBAL) cp_async_commit();
  for (int it = 0; tile < tiles; tile += blocks, ++it) {
    const int ns = min(a.S2, a.B - tile * a.S2);
    float* const st = (it & 1) ? stage1 : stage0;
    if (!GLOBAL) cp_async_wait<1>();
    __syncthreads();
    // each pool-2 cell's gradient: the features' over the average pool's
    // window size; the codes as [window][channel], 8 channels a word pair
    for (int s = 0; s < ns; ++s) {
      float* row = st + s * a.w2_st;
      for (int k = tid; k < nf; k += kBwdThreads) {
        row[a.w2_g2 + k] = __fdiv_rn(row[a.w2_g2 + k], count);
      }
      const uint8_t* codes = reinterpret_cast<const uint8_t*>(row + a.w2_c2);
      uint8_t* by_window = reinterpret_cast<uint8_t*>(row + a.w2_ct);
      for (int i = tid; i < kC * nq2; i += kBwdThreads) {
        const int q = i / kC, c = i - q * kC;
        by_window[i] = codes[c * nq2 + q];
      }
    }
    __syncthreads();
    for (int i = share; i < ns * nq2; i += per) {
      const int s = divide(i, nq2, inv_nq), q = i - s * nq2;
      const int qy = divide(q, a.UW2, inv_uw), qx = q - qy * a.UW2;
      const float* row = st + s * a.w2_st;
      const float* plane =
          row + a.w2_p1 + lane * a.b_p1pp + 2 * qy * a.b_p1w + 2 * qx;
      float p[4][4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
#pragma unroll
        for (int x = 0; x < 4; ++x) p[y][x] = plane[y * a.b_p1w + x];
      }
      const uint2 codes = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const uint8_t*>(row + a.w2_ct) + q * kC +
          kGroup * group);
      const float* gq = row + a.w2_g2 + gcell[q] * kC + kGroup * group;
      const float4 g0 = *reinterpret_cast<const float4*>(gq);
      const float4 g1 = *reinterpret_cast<const float4*>(gq + 4);
      const float g[kGroup] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
      if (((mine < 4 ? codes.x : codes.y) >> (8 * (mine % 4))) & 0xffu) {
        bias += gq[mine];
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const uint32_t code = ((j < 4 ? codes.x : codes.y) >> (8 * (j % 4))) &
                              0xffu;
        if (code == 0) continue;
        switch (code) {
          case 1: add_patch<0, 0>(acc[j], g[j], p); break;
          case 2: add_patch<0, 1>(acc[j], g[j], p); break;
          case 3: add_patch<1, 0>(acc[j], g[j], p); break;
          default: add_patch<1, 1>(acc[j], g[j], p); break;
        }
      }
    }
    __syncthreads();
    if (tile + 2 * blocks < tiles) issue(tile + 2 * blocks, st);
    if (!GLOBAL) cp_async_commit();
  }
  if (!GLOBAL) cp_async_wait<0>();
  // this block's partial sums of dw2 and db2: the warps of a group add
  // theirs in warp order, a round each
  float* out = a.partial + static_cast<size_t>(block) * a.nw +
               kC * a.Cin * 9 + kC;
  for (int r = 0; r < per; ++r) {
    if (share == r) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int co = kGroup * group + j;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          float* o = out + (co * kC + lane) * 9 + k;
          *o = r ? *o + acc[j][k] : acc[j][k];
        }
      }
      if (lane < kGroup) {
        float* o = out + kC * kC * 9 + kGroup * group + lane;
        *o = r ? *o + bias : bias;
      }
    }
    __syncthreads();
  }
}

// Both convolutions' weight gradients in one launch: even blocks take
// conv1's (w1_grad_block), odd ones conv2's (w2_grad_block), each over
// gridDim.x / 2 persistent blocks, so that an SM holds one of each: conv1's
// is bound by shared-memory loads and conv2's by its issue of branches and
// FFMA, and each fills the other's stalls.
template <typename T, bool GLOBAL1, bool GLOBAL2>
__global__ void __launch_bounds__(kBwdThreads, 2)
    trunk_weight_grads_kernel(const TrunkArgs a) {
  extern __shared__ float4 smem_raw[];
  const int block = blockIdx.x / 2, blocks = gridDim.x / 2;
  if (blockIdx.x % 2 == 0) {
    w1_grad_block<T, GLOBAL1>(a, smem_raw, block, blocks);
  } else {
    w2_grad_block<GLOBAL2>(a, smem_raw, block, blocks);
  }
}

// out[i] = the partials' column i summed in block order.
__global__ void trunk_reduce_kernel(const float* __restrict__ partial,
                                    int blocks, int nw,
                                    float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nw) return;
  float sum = 0.0f;
  for (int k = 0; k < blocks; ++k) {
    sum += partial[static_cast<size_t>(k) * nw + i];
  }
  out[i] = sum;
}

using KernelFn = void (*)(const TrunkArgs);

// The kernels by slot: the forward by (float obs, saving, planes in
// device memory), the last flag fastest; the pool-1 gradient; both weight
// gradients by (float obs, conv1's planes in device memory, conv2's).
#define TRUNK_WGRADS(T) \
  trunk_weight_grads_kernel<T, false, false>,               \
      trunk_weight_grads_kernel<T, false, true>,            \
      trunk_weight_grads_kernel<T, true, false>,            \
      trunk_weight_grads_kernel<T, true, true>
constexpr int kKernels = 8 + 1 + 8;
const KernelFn kernels[kKernels] = {
    trunk_forward_kernel<uint8_t, false, false>,
    trunk_forward_kernel<uint8_t, false, true>,
    trunk_forward_kernel<uint8_t, true, false>,
    trunk_forward_kernel<uint8_t, true, true>,
    trunk_forward_kernel<float, false, false>,
    trunk_forward_kernel<float, false, true>,
    trunk_forward_kernel<float, true, false>,
    trunk_forward_kernel<float, true, true>,
    trunk_pool1_grad_kernel,
    TRUNK_WGRADS(uint8_t),
    TRUNK_WGRADS(float)};
#undef TRUNK_WGRADS

// kind 0: the forward, `arg` nonzero where it saves; kind 1: the weight
// gradients, `arg` the input channels (1 to kMaxCin), `global` 1 and 2
// bits for conv1's and conv2's planes in device memory; kind 2: the pool-1
// gradient. -1 where there is no such kernel.
int slot(int kind, int is_float, int arg, int global) {
  if (is_float < 0 || is_float > 1 || global < 0 || global > 3) return -1;
  switch (kind) {
    case 0:
      return global > 1 ? -1 : (is_float * 2 + (arg ? 1 : 0)) * 2 + global;
    case 1: return arg < 1 || arg > kMaxCin ? -1
                                            : 9 + is_float * 4 +
                                                  (global & 1) * 2 + global / 2;
    case 2: return 8;
    default: return -1;
  }
}

int threads(int id) { return id < 8 ? kThreads : kBwdThreads; }

// The dynamic shared memory each kernel was last allowed, by slot and
// device: set only when a launch needs more, so that a launch recorded into
// a CUDA graph after the first call of its shape makes no such call.
constexpr int kMaxDevices = 64;
int smem_allowed[kKernels][kMaxDevices];

int allow_smem(int id, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* allowed = device < kMaxDevices ? &smem_allowed[id][device] : nullptr;
  if (allowed != nullptr && *allowed >= bytes) return 0;
  err = cudaFuncSetAttribute(
      kernels[id], cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (allowed != nullptr) *allowed = bytes;
  return 0;
}

int launch(int id, int grid, int smem, cudaStream_t stream,
           const TrunkArgs& args) {
  const int rc = allow_smem(id, smem);
  if (rc != 0) return rc;
  kernels[id]<<<grid, threads(id), smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Blocks of a kernel (kind, arg and global as `slot` takes them) with
// `smem` bytes of dynamic shared memory that one SM holds at once, or a
// negative CUDA error.
extern "C" int marlsnake_trunk_occupancy(int kind, int is_float, int arg,
                                         int global, int smem) {
  const int id = slot(kind, is_float, arg, global);
  if (id < 0) return -static_cast<int>(cudaErrorInvalidValue);
  const int rc = allow_smem(id, smem);
  if (rc != 0) return -rc;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernels[id], threads(id), smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// The features of args->B rows: `grid` persistent blocks; saves the
// backward's inputs where args->p1 is not null.
extern "C" int marlsnake_trunk_forward(const TrunkArgs* args, int is_float,
                                       int grid, int smem, void* stream) {
  if (args->B == 0) return 0;
  const int id =
      slot(0, is_float, args->p1 != nullptr, args->scratch != nullptr);
  if (id < 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch(id, grid, smem, static_cast<cudaStream_t>(stream), *args);
}

// The weight and bias gradients of args->B rows into args->grads: the
// pool-1 gradient into args->dp1 (`grid_p` blocks, `smem_p` bytes), both
// convolutions' weight gradients' partial sums into args->partial (2 x
// `pairs` blocks of `smem_w` bytes, a partial row a pair), and their sums.
extern "C" int marlsnake_trunk_backward(const TrunkArgs* args, int is_float,
                                        int grid_p, int smem_p, int pairs,
                                        int smem_w, void* stream) {
  const int id = slot(1, is_float, args->Cin,
                      (args->scratch != nullptr) +
                          2 * (args->scratch2 != nullptr));
  if (id < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (args->B > 0) {
    int rc = launch(slot(2, 0, 0, 0), grid_p, smem_p, s, *args);
    if (rc == 0) rc = launch(id, 2 * pairs, smem_w, s, *args);
    if (rc != 0) return rc;
  } else {
    pairs = 0;
  }
  trunk_reduce_kernel<<<(args->nw + 255) / 256, 256, 0, s>>>(
      args->partial, pairs, args->nw, args->grads);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* marlsnake_trunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
