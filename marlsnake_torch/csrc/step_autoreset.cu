// Batched snake step with observation encode, with and without fused
// auto-reset: one kernel body, instantiated twice.
//
// step_autoreset_kernel (step_body<true>) replaces the Pallas TPU kernel
// marlsnake_tpu/ops/pallas_step.py::_step_block (:54-329) and the obs-encode
// epilogue of its launcher, build_pallas_step (:332-491); its plain PyTorch
// version is marlsnake_torch/core/engine.py::step_autoreset.
// step_noreset_kernel (step_body<false>) is the same step with the reset
// compiled out (no reset draw, pool row or base grid is read): the DQN
// trainer's env step, which the JAX package leaves to XLA
// (marlsnake_tpu/core/engine.py::step); its plain version is
// marlsnake_torch/core/engine.py::step. That entry can also hold envs still
// (the trainer's finished envs): an env whose `keep` flag is set is copied
// from the input arena, state and step output, instead of being stepped.
// Kernel and plain version take every random number as an input, so they
// agree bit for bit, floats included.
//
// Both entries cover every EnvConfig option, each uniform over a launch and
// so a warp-uniform branch on a field of StepArgs:
// - spawn_mode 'procedural': a resetting env paints the bordered board and
//   one straight segment a snake, computed from the snake's four uniforms
//   (engine.py::_procedural_spawn); no pool row and no base grid is read.
// - obs_format 'packed': one byte a cell a snake (bit c = channel c) in
//   place of eight one-hot bytes.
// - frame_stack > 1, full obs: the state carries the frame_stack - 1 past
//   grids (hist_grid). The launch shifts them (drop the oldest, append the
//   PRE-step grid; a reset env's history is its own new grid in every slot)
//   and encodes every frame into the obs, frame-major, oldest first. The
//   past grids are read from the input arena in global memory, so shared
//   memory holds one grid an env whatever the stack.
// - vision_range: the obs is the (2v+1)^2 window of the shared-memory grid
//   around each snake's head ((0, 0) for a dead snake), cells outside the
//   grid EMPTY. With frame_stack > 1 the state carries the encoded window
//   frames (obs_stack), which the launch rolls (a reset env's stack is its
//   first frame in every slot).
//
// What bounds it on an H100: bytes. Per env-step the kernel reads the state
// (grid H*W int32, the 2-bit rings, ~50 bytes per snake, the draws) and
// writes the new state plus the observation, (N, H, W, 8) uint8 by default.
// At 4096 envs of 20x20 with 4 snakes that is about 70 MB (12.8 KB of each
// env's 17.2 KB is the obs), 21 us at 3.35 TB/s. Its arithmetic is a few integer
// operations per byte, far below the card's rates. Tensor cores and wgmma
// play no part: this is integer control flow and byte movement.
//
// Design, against latency:
// - One warp per env, lane i = snake i (N <= 32), up to 8 envs per block,
//   each warp on its own slice of shared memory (grid and rings). There is
//   no block-wide barrier: a warp syncs with __syncwarp() and its lanes
//   talk through warp intrinsics (__match_any_sync for same-target groups,
//   __ballot_sync masks, __shfl_sync loops over the N snakes,
//   __reduce_add_sync for counts). 4096 envs are 4096 warps, one wave on
//   132 SMs at 32 resident warps each (<= 64 registers a thread).
// - Every global read starts at entry: the grid and the rings with
//   16-byte cp.async copies into shared memory, each lane's snake fields,
//   draws and the env's scalars into registers.
// - The fruit pick counts empty cells per 32-cell chunk with __ballot_sync
//   and __popc and finds a draw's cell inside its chunk with __fns: no
//   prefix buffer.
// - The obs is stored 16 bytes per lane (two cells of one snake), 512
//   contiguous bytes per warp store. A lane encodes its two cells once and
//   stores them in every snake's plane, with the streaming hint (st.global.cs):
//   both measured faster than a snake-outer loop with plain stores. The
//   packed obs does the same with 16 cells a lane (store_planes). A full-obs
//   frame stack takes the same path: a snake's plane is then the run of every
//   grid cell's FS frames. A vision window differs from snake to snake and
//   goes through store_units: the destination is a run of units (8 one-hot
//   bytes, or 1 packed byte), 16 bytes a lane, each unit computed from its
//   (frame, snake, cell) index.
// - Cell writes that may overlap (old head, tail erase, new head, new tail)
//   run on lane 0 in the engine's last-writer-wins order.
//
// Exactness: float sums use __fmul_rn/__fadd_rn in the engine's order (and
// the library is built with -fmad=false); kills are an integer count held in
// float, so their order of addition does not matter; ring bit work is on
// uint32_t; ring indices are floor-modulo, as in PyTorch and JAX.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWarps = 8;           // envs per block
constexpr int kMaxSmem = 232448;       // shared memory of one block (227 KB)
constexpr unsigned kFull = 0xffffffffu;

constexpr int EMPTY = 0, WALL = 1, FRUIT = 2, HEAD = 3, BODY = 4, TAIL = 5;
constexpr int OWNER_SHIFT = 4;
constexpr int UP = 0, RIGHT = 1, DOWN = 2, LEFT = 3;

}  // namespace

// Field order is mirrored by ctypes in marlsnake_torch/ops/step_kernel.py;
// tests/test_torch_step_kernel.py parses this struct and checks the mirror.
struct StepArgs {
  // The state comes in as one arena and goes out in another, with the step
  // output behind it; the o_* byte offsets (16-byte aligned) hold for both.
  const uint8_t* state;            // the first 16 fields of the layout, or
                                   // all 25 where `keep` is given
  uint8_t* out;                    // all 25 fields
  const int32_t* actions;          // (B, N)
  const float* fruit_u;            // (B, N)
  // read by the auto-reset entry only; null for the plain step
  const float* reset_spawn_u;      // (B,), or (B, N, 4) where procedural
  const float* reset_fruit_u;      // (B, NF)
  const int32_t* pool_cells;       // (P, N*K); null where procedural
  const int32_t* base_grid;        // (HW,); null where procedural
  // read by the plain step only: envs to hold still (see hold_env), or null
  const uint8_t* keep;             // (B,) bool
  int64_t o_grid;                  // (B, HW) int32
  int64_t o_direction;             // (B, N) int32
  int64_t o_head;                  // (B, N, 2) int32
  int64_t o_tail;                  // (B, N, 2) int32
  int64_t o_ring;                  // (B, N, CW) int32
  int64_t o_ring_head;             // (B, N) int32
  int64_t o_ring_len;              // (B, N) int32
  int64_t o_alive;                 // (B, N) bool
  int64_t o_alive_count;           // (B,) int32
  int64_t o_epi_scores;            // (B, N) float32
  int64_t o_epi_steps;             // (B, N) float32
  int64_t o_epi_fruits;            // (B, N) float32
  int64_t o_epi_kills;             // (B, N) float32
  int64_t o_episode_length;        // (B,) int32
  int64_t o_hist_grid;             // (B, FS-1, HW) int32; empty unless
                                   // FS > 1 and V == 0
  int64_t o_obs_stack;             // (B, FS, N, P, U) uint8; empty unless
                                   // FS > 1 and V > 0
  int64_t o_obs;                   // (B, N, P, FS*U) uint8: P = HW cells, or
                                   // (2V+1)^2 with vision; U = 8 bytes a
                                   // cell a frame, or 1 where packed
  int64_t o_reward;                // (B, N) float32
  int64_t o_done;                  // (B, N) bool
  int64_t o_rank;                  // (B, N) int32
  int64_t o_episode_scores;        // (B, N) float32
  int64_t o_episode_steps;         // (B, N) float32
  int64_t o_episode_fruits;        // (B, N) float32
  int64_t o_episode_kills;         // (B, N) float32
  int64_t o_done_all;              // (B,) bool
  // shapes and config
  int B;
  int H;
  int W;
  int N;
  int K;
  int NF;
  int P;
  int CW;
  int cap;
  int human;
  int any_mode;
  int max_steps;
  int FS;                          // frame_stack
  int V;                           // vision_range, 0 for the whole grid
  int packed;                      // obs_format == 'packed'
  int procedural;                  // spawn_mode == 'procedural'
  int vertical;                    // ... with vertical segments too
  float r_fruit;
  float r_kill;
  float r_lose;
  float r_win;
  float r_time;
};

// Field at byte offset `offset` of the input state arena / the output arena.
template <typename T>
__device__ __forceinline__ const T* in(const StepArgs& a, int64_t offset) {
  return reinterpret_cast<const T*>(a.state + offset);
}

template <typename T>
__device__ __forceinline__ T* at(const StepArgs& a, int64_t offset) {
  return reinterpret_cast<T*>(a.out + offset);
}

__device__ __forceinline__ int pmod(int x, int m) { return ((x % m) + m) % m; }
__device__ __forceinline__ int drow(int d) { return (d == DOWN) - (d == UP); }
__device__ __forceinline__ int dcol(int d) { return (d == RIGHT) - (d == LEFT); }
__device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// (row, col) as one word: equal words <=> equal pairs for |row|, |col| <
// 32768, far beyond any board.
__device__ __forceinline__ unsigned pack(int r, int c) {
  return (static_cast<unsigned>(r) << 16) | (static_cast<unsigned>(c) & 0xffffu);
}

__device__ __forceinline__ int next_dir(int d, int a, int human) {
  a = min(max(a, 0), 4);
  if (human) {
    const bool horiz = (d % 2) == 1;
    if (horiz && a == 3) return DOWN;
    if (horiz && a == 4) return UP;
    if (!horiz && a == 1) return LEFT;
    if (!horiz && a == 2) return RIGHT;
    return d;
  }
  return (d + (a == 2) - (a == 1) + 4) & 3;
}

// A draw's pick among m choices: the float32 product truncated and clamped.
__device__ __forceinline__ int pick(float u, int m) {
  return min(static_cast<int>(__fmul_rn(u, static_cast<float>(m))), m - 1);
}

__device__ __forceinline__ int flat_delta_to_dir(int d, int w) {
  return d == -w ? UP : (d == 1 ? RIGHT : (d == w ? DOWN : LEFT));
}

// An obs cell is a little-endian 8-byte word (two 32-bit halves), byte c =
// channel c: wall, fruit, other head/body/tail, my head/body/tail. Its
// owner's word differs from every other snake's on snake cells only.
struct ObsCell {
  uint2 other, mine;
  int owner;  // -1 where no snake owns the cell
};

__device__ __forceinline__ uint2 channel_word(int ch) {
  return make_uint2(ch < 4 ? 1u << (8 * ch) : 0u,
                    ch >= 4 && ch < 8 ? 1u << (8 * (ch - 4)) : 0u);
}

__device__ __forceinline__ ObsCell obs_cell(int v) {
  const int t = v & 15;
  if (t >= HEAD)
    return {channel_word(2 + t - HEAD), channel_word(5 + t - HEAD),
            v >> OWNER_SHIFT};
  const uint2 w = t == WALL || t == FRUIT ? channel_word(t - WALL)
                                          : make_uint2(0u, 0u);
  return {w, w, -1};
}

// The same cell as one byte, bit c = channel c, as snake s sees it.
__device__ __forceinline__ unsigned cell_byte(int v, int s) {
  const int t = v & 15;
  if (t >= HEAD) return (4u << (t - HEAD)) << ((v >> OWNER_SHIFT) == s ? 3 : 0);
  return t == WALL ? 1u : (t == FRUIT ? 2u : 0u);
}

// A byte's bits as 8 one-hot bytes (bit c -> byte c).
__device__ __forceinline__ uint2 spread(unsigned byte) {
  return make_uint2(((byte & 15u) * 0x00204081u) & 0x01010101u,
                    ((byte >> 4) * 0x00204081u) & 0x01010101u);
}

// Sizes of one env's obs and history rows.
struct ObsRows {
  int P;         // cells of one snake's frame
  int U;         // bytes of a cell in one frame
  size_t obs;    // bytes of the obs
  size_t hist;   // bytes of hist_grid (0 unless the raw-grid history is on)
  size_t stack;  // bytes of obs_stack (0 unless the stored-frame stack is on)
};

__device__ __forceinline__ ObsRows obs_rows(const StepArgs& a) {
  ObsRows r;
  const int HW = a.H * a.W, v2 = 2 * a.V + 1;
  r.P = a.V ? v2 * v2 : HW;
  r.U = a.packed ? 1 : 8;
  const size_t frame = static_cast<size_t>(a.N) * r.P * r.U;
  r.obs = frame * a.FS;
  r.hist = (a.FS > 1 && !a.V) ? static_cast<size_t>(a.FS - 1) * HW * 4 : 0;
  r.stack = (a.FS > 1 && a.V) ? frame * a.FS : 0;
  return r;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The warp copies n int32 from global to its shared slice (16-byte aligned)
// without waiting: 16 bytes a lane where the source allows, else 4. The
// caller waits with cp_async_wait_all() and __syncwarp().
__device__ __forceinline__ void copy_in(int* dst, const int32_t* src, int n,
                                        int lane) {
  if ((n & 3) == 0 && aligned16(src)) {
    for (int x = 4 * lane; x < n; x += 128) cp_async16(dst + x, src + x);
  } else {
    for (int x = lane; x < n; x += 32) cp_async4(dst + x, src + x);
  }
}

__device__ __forceinline__ void copy_out(int32_t* dst, const int* src, int n,
                                         int lane) {
  if ((n & 3) == 0 && aligned16(dst) && aligned16(src)) {
    for (int x = 4 * lane; x < n; x += 128)
      *reinterpret_cast<int4*>(dst + x) = *reinterpret_cast<const int4*>(src + x);
  } else {
    for (int x = lane; x < n; x += 32) dst[x] = src[x];
  }
}

// The warp copies one env's row of a field from the input arena to the
// output arena, 16 bytes a lane where size and address allow, else 4, else
// (a packed obs of odd size) 1. The loads are read-only
// (ld.global.nc) and the loops unrolled, so that a lane has several loads in
// flight before its first store.
__device__ __forceinline__ void copy_row(const StepArgs& a, int64_t offset,
                                         size_t row_bytes, int b, int lane) {
  const uint8_t* src = a.state + offset + b * row_bytes;
  uint8_t* dst = a.out + offset + b * row_bytes;
  const int n = static_cast<int>(row_bytes);
  if ((n & 15) == 0 && aligned16(src) && aligned16(dst)) {
#pragma unroll 4
    for (int x = 16 * lane; x < n; x += 512)
      *reinterpret_cast<int4*>(dst + x) = __ldg(reinterpret_cast<const int4*>(src + x));
  } else if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 3) == 0) {
#pragma unroll 4
    for (int x = 4 * lane; x < n; x += 128)
      *reinterpret_cast<int32_t*>(dst + x) =
          __ldg(reinterpret_cast<const int32_t*>(src + x));
  } else {
    for (int x = lane; x < n; x += 32) dst[x] = __ldg(src + x);
  }
}

// store_units writes a run of units at dst: a (d0, d1, d2) array in row-major
// order whose unit (i0, i1, i2) is unit_fn(i0, i1, i2). A lane stores 16 bytes
// (streaming stores, 512 contiguous bytes a warp) where dst is 16-byte aligned
// and the units fill whole 16-byte words: it decodes the index of its first
// unit and steps through the rest. Else it stores unit by unit. Every lane
// calls unit_fn equally often, with an index inside the array, so unit_fn may
// use warp intrinsics.
__device__ __forceinline__ void put_unit(unsigned (&w)[4], int i, uint2 u) {
  w[2 * i] = u.x;
  w[2 * i + 1] = u.y;
}

__device__ __forceinline__ void put_unit(unsigned (&w)[4], int i, uint8_t u) {
  w[i >> 2] |= static_cast<unsigned>(u) << (8 * (i & 3));
}

template <typename Unit, typename F>
__device__ __forceinline__ void store_units(uint8_t* dst, int d0, int d1, int d2,
                                            int lane, F unit_fn) {
  constexpr int kGroup = 16 / static_cast<int>(sizeof(Unit));
  const int total = d0 * d1 * d2;
  const bool wide = aligned16(dst) && total % kGroup == 0;
  const int group = wide ? kGroup : 1;
  const int words = total / group;
  for (int base = 0; base < words; base += 32) {
    const int x = base + lane;
    const bool ok = x < words;
    const int q = ok ? x * group : 0, r = q / d2;
    int i2 = q - r * d2, i0 = r / d1, i1 = r - i0 * d1;
    if (wide) {
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        put_unit(w, i, unit_fn(i0, i1, i2));
        if (++i2 == d2) {
          i2 = 0;
          if (++i1 == d1) {
            i1 = 0;
            ++i0;
          }
        }
      }
      // a lane's last step may leave the array; that index is not used
      if (ok) __stcs(reinterpret_cast<uint4*>(dst) + x, make_uint4(w[0], w[1], w[2], w[3]));
    } else {
      const Unit u = unit_fn(i0, i1, i2);
      if (ok) reinterpret_cast<Unit*>(dst)[x] = u;
    }
  }
}

// The obs of a vision config, and the stored frames behind it. Unit (f, s, p)
// is frame f (oldest first) of cell p of the window around snake s's head
// (`anchor`: each lane's own snake's, row << 16 | col). Frame FS-1 is cut from
// the state's own grid g (shared memory), as is every frame of an env that
// has just been reset; an older frame f is the stored encoded frame f+1 of
// obs_stack in the input arena.
template <typename Unit>
__device__ __forceinline__ void store_windows(const StepArgs& a, const int* g,
                                              int b, int lane, bool fresh,
                                              unsigned anchor) {
  const int H = a.H, W = a.W, N = a.N, FS = a.FS, V = a.V;
  const ObsRows rows = obs_rows(a);
  const int P = rows.P, NP = N * P, v2 = 2 * V + 1;
  const Unit* in_stack =
      reinterpret_cast<const Unit*>(a.state + a.o_obs_stack + b * rows.stack);
  auto unit = [&](int f, int s, int p) -> Unit {
    const unsigned anc = __shfl_sync(kFull, anchor, s);  // before any branch
    if (!fresh && f != FS - 1)
      return __ldg(in_stack + static_cast<size_t>(f + 1) * NP + s * P + p);
    const int y = p / v2, x = p - y * v2;
    const int r = static_cast<int>(anc >> 16) - V + y;
    const int c = static_cast<int>(anc & 0xffffu) - V + x;
    const bool inside = r >= 0 && r < H && c >= 0 && c < W;
    const unsigned byte = cell_byte(inside ? g[r * W + c] : EMPTY, s);
    if constexpr (sizeof(Unit) == 1) return static_cast<Unit>(byte);
    else return spread(byte);
  };
  store_units<Unit>(a.out + a.o_obs + b * rows.obs, N, P, FS, lane,
                    [&](int s, int p, int f) { return unit(f, s, p); });
  if (rows.stack)
    store_units<Unit>(a.out + a.o_obs_stack + b * rows.stack, FS, N, P, lane, unit);
}

// The obs of a full-obs config: every snake's plane is the same run of
// `cells` cells (the grid, or with a frame stack each grid cell's FS frames
// side by side) and differs only where the snake owns a cell. fetch(j0, v)
// fills v with the sizeof(v)/4 cells from j0 on. A lane encodes its cells once
// and stores their 16 bytes in every snake's plane (a warp store is 512
// contiguous bytes): two cells of eight one-hot bytes, or 16 packed cells
// (their bytes as another snake sees them and their owners + 1; the owner's
// bits 2..4 move to 5..7).
template <typename Fetch>
__device__ __forceinline__ void store_planes(const StepArgs& a, int b, int lane,
                                             int cells, Fetch fetch) {
  const int N = a.N;
  if (a.packed) {
    uint8_t* obs = at<uint8_t>(a, a.o_obs) + static_cast<size_t>(b) * N * cells;
    if ((cells & 15) == 0 && aligned16(obs)) {
      uint4* dst = reinterpret_cast<uint4*>(obs);
      const int plane = cells / 16;  // 16-byte words per snake
      for (int p = lane; p < plane; p += 32) {
        unsigned other[4], owner[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          int v[4];
          fetch(16 * p + 4 * i, v);
          other[i] = owner[i] = 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            other[i] |= cell_byte(v[j], -1) << (8 * j);
            if ((v[j] & 15) >= HEAD)
              owner[i] |= static_cast<unsigned>((v[j] >> OWNER_SHIFT) + 1) << (8 * j);
          }
        }
        for (int s = 0; s < N; ++s) {
          unsigned w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const unsigned m = __vcmpeq4(owner[i], 0x01010101u * (s + 1));
            w[i] = (other[i] & ~m) | ((other[i] << 3) & m);
          }
          __stcs(dst + s * plane + p, make_uint4(w[0], w[1], w[2], w[3]));
        }
      }
    } else {
      for (int c = lane; c < cells; c += 32) {
        int v[1];
        fetch(c, v);
        for (int s = 0; s < N; ++s)
          obs[s * cells + c] = static_cast<uint8_t>(cell_byte(v[0], s));
      }
    }
    return;
  }
  uint8_t* obs = at<uint8_t>(a, a.o_obs) + static_cast<size_t>(b) * N * cells * 8;
  if ((cells & 1) == 0 && aligned16(obs)) {
    uint4* dst = reinterpret_cast<uint4*>(obs);
    const int plane = cells / 2;  // 16-byte words per snake
    for (int p = lane; p < plane; p += 32) {
      int v[2];
      fetch(2 * p, v);
      const ObsCell c0 = obs_cell(v[0]), c1 = obs_cell(v[1]);
      for (int s = 0; s < N; ++s) {
        const uint2 w0 = c0.owner == s ? c0.mine : c0.other;
        const uint2 w1 = c1.owner == s ? c1.mine : c1.other;
        __stcs(dst + s * plane + p, make_uint4(w0.x, w0.y, w1.x, w1.y));
      }
    }
  } else {
    uint2* dst = reinterpret_cast<uint2*>(obs);
    for (int c = lane; c < cells; c += 32) {
      int v[1];
      fetch(c, v);
      const ObsCell c0 = obs_cell(v[0]);
      for (int s = 0; s < N; ++s) dst[s * cells + c] = c0.owner == s ? c0.mine : c0.other;
    }
  }
}

// The raw-grid history after the step: slot i takes past grid i+1, the last
// slot the PRE-step grid, all from the input arena; a fresh env's slots all
// take its new grid g.
__device__ __forceinline__ void store_hist(const StepArgs& a, const int* g,
                                           int b, int lane, bool fresh) {
  const int HW = a.H * a.W, slots = a.FS - 1;
  const int32_t* in_grid = in<int32_t>(a, a.o_grid) + static_cast<size_t>(b) * HW;
  const int32_t* in_hist =
      in<int32_t>(a, a.o_hist_grid) + static_cast<size_t>(b) * slots * HW;
  int32_t* out_hist =
      at<int32_t>(a, a.o_hist_grid) + static_cast<size_t>(b) * slots * HW;
  for (int i = 0; i < slots; ++i) {
    const int* src = fresh ? g : (i == slots - 1 ? in_grid : in_hist + (i + 1) * HW);
    copy_out(out_hist + i * HW, src, HW, lane);
  }
}

// An env that is held still leaves the step as it came in: all 25 fields of
// its row, state and step output, are copied from the input arena, which must
// then be a whole arena (the output of the step before). As in the step
// itself, the per-snake and per-env values are all loaded before any is
// stored; the grid, the rings, the history and the obs are copied in between.
__device__ __forceinline__ void hold_env(const StepArgs& a, int b, int lane) {
  const int N = a.N, HW = a.H * a.W;
  const int e = b * N + lane;
  const bool snake = lane < N;
  // the (B, N) fields of 4-byte elements, then head and tail (two each)
  const int64_t words[] = {
      a.o_direction,      a.o_ring_head,     a.o_ring_len,       a.o_epi_scores,
      a.o_epi_steps,      a.o_epi_fruits,    a.o_epi_kills,      a.o_reward,
      a.o_rank,           a.o_episode_scores, a.o_episode_steps,
      a.o_episode_fruits, a.o_episode_kills};
  constexpr int kWords = sizeof(words) / sizeof(words[0]);
  const int64_t pairs[] = {a.o_head, a.o_tail};
  const int64_t flags[] = {a.o_alive, a.o_done};      // (B, N) bool
  const int64_t scalars[] = {a.o_alive_count, a.o_episode_length};  // (B,)
  int32_t w[kWords] = {}, p[2][2] = {}, sc[2] = {};
  uint8_t f[2] = {}, done_all = 0;
  if (snake) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldg(in<int32_t>(a, words[i]) + e);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      p[i][0] = __ldg(in<int32_t>(a, pairs[i]) + 2 * e);
      p[i][1] = __ldg(in<int32_t>(a, pairs[i]) + 2 * e + 1);
      f[i] = __ldg(in<uint8_t>(a, flags[i]) + e);
    }
  }
  if (lane == 0) {
    sc[0] = __ldg(in<int32_t>(a, scalars[0]) + b);
    sc[1] = __ldg(in<int32_t>(a, scalars[1]) + b);
    done_all = __ldg(in<uint8_t>(a, a.o_done_all) + b);
  }
  copy_row(a, a.o_grid, static_cast<size_t>(HW) * 4, b, lane);
  copy_row(a, a.o_ring, static_cast<size_t>(N) * a.CW * 4, b, lane);
  const ObsRows rows = obs_rows(a);
  copy_row(a, a.o_obs, rows.obs, b, lane);
  if (rows.hist) copy_row(a, a.o_hist_grid, rows.hist, b, lane);
  if (rows.stack) copy_row(a, a.o_obs_stack, rows.stack, b, lane);
  if (snake) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) at<int32_t>(a, words[i])[e] = w[i];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      at<int32_t>(a, pairs[i])[2 * e] = p[i][0];
      at<int32_t>(a, pairs[i])[2 * e + 1] = p[i][1];
      at<uint8_t>(a, flags[i])[e] = f[i];
    }
  }
  if (lane == 0) {
    at<int32_t>(a, scalars[0])[b] = sc[0];
    at<int32_t>(a, scalars[1])[b] = sc[1];
    at<uint8_t>(a, a.o_done_all)[b] = done_all;
  }
}

// kReset: an env whose episode-done predicate fires leaves the step as a
// fresh reset. Without it the env keeps its finished state (the reward,
// done, rank and stats outputs are the same either way).
template <bool kReset>
__device__ __forceinline__ void step_body(const StepArgs& a) {
  extern __shared__ __align__(16) int smem[];
  const int H = a.H, W = a.W, HW = H * W, N = a.N, K = a.K, CW = a.CW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= a.B) return;  // the whole warp: there is no block barrier
  if constexpr (!kReset) {
    if (a.keep != nullptr && a.keep[b]) {  // uniform across the warp
      hold_env(a, b, lane);
      return;
    }
  }
  const int ncw = N * CW;
  int* g = smem + warp * (round4(HW) + round4(ncw));
  uint32_t* ring = reinterpret_cast<uint32_t*>(g + round4(HW));
  const bool snake = lane < N;
  const int e = b * N + lane;
  const unsigned below = (1u << lane) - 1u;  // lanes under mine

  // --- every global read, started up front ---
  copy_in(g, in<int32_t>(a, a.o_grid) + static_cast<size_t>(b) * HW, HW, lane);
  copy_in(reinterpret_cast<int*>(ring),
          in<int32_t>(a, a.o_ring) + static_cast<size_t>(b) * ncw, ncw, lane);
  int d = 0, act = 0, hr = 0, hc = 0, tlr = 0, tlc = 0, al0 = 0, nrh = 0,
      nrl = 0;
  float es = 0.0f, est = 0.0f, ef = 0.0f, ek = 0.0f, fu = 0.0f;
  if (snake) {
    d = __ldg(in<int32_t>(a, a.o_direction) + e);
    act = __ldg(a.actions + e);
    hr = __ldg(in<int32_t>(a, a.o_head) + 2 * e);
    hc = __ldg(in<int32_t>(a, a.o_head) + 2 * e + 1);
    tlr = __ldg(in<int32_t>(a, a.o_tail) + 2 * e);
    tlc = __ldg(in<int32_t>(a, a.o_tail) + 2 * e + 1);
    al0 = __ldg(in<uint8_t>(a, a.o_alive) + e) != 0;
    nrh = __ldg(in<int32_t>(a, a.o_ring_head) + e);
    nrl = __ldg(in<int32_t>(a, a.o_ring_len) + e);
    es = __ldg(in<float>(a, a.o_epi_scores) + e);
    est = __ldg(in<float>(a, a.o_epi_steps) + e);
    ef = __ldg(in<float>(a, a.o_epi_fruits) + e);
    ek = __ldg(in<float>(a, a.o_epi_kills) + e);
    fu = __ldg(a.fruit_u + e);
  }
  float ru = 0.0f, spawn_u = 0.0f;
  if constexpr (kReset) {
    if (lane < a.NF)
      ru = __ldg(a.reset_fruit_u + static_cast<size_t>(b) * a.NF + lane);
    if (!a.procedural) spawn_u = __ldg(a.reset_spawn_u + b);
  }
  const int acount0 = __ldg(in<int32_t>(a, a.o_alive_count) + b);
  const int elen = __ldg(in<int32_t>(a, a.o_episode_length) + b) + 1;
  cp_async_wait_all();
  __syncwarp();

  // --- Phase 1: turn + proposed heads ---
  int nd = al0 ? next_dir(d, act, a.human) : d;
  const int tr = hr + drow(nd), tc = hc + dcol(nd);
  const int tf = tr * W + tc;
  const int cell = (snake && tf >= 0 && tf < HW) ? g[tf] : 0;
  const int type = cell & 15;
  const int owner = min(max(cell >> OWNER_SHIFT, 0), N - 1);
  const unsigned key = pack(tr, tc), tail_key = pack(tlr, tlc);

  // --- Phase 2: collision vs the pre-move grid ---
  const unsigned alive0 = __ballot_sync(kFull, al0);
  const unsigned same = __match_any_sync(kFull, key) & alive0;
  const int multi = al0 && __popc(same) >= 2;
  const int deadly = type == WALL || type == BODY || type == HEAD;
  const int primary = al0 && (same & below) == 0;
  const int eats = al0 && !multi && !deadly && type == FRUIT;
  const int dcoll = al0 && (multi || deadly);
  const int kc = primary && (type == BODY || type == HEAD);
  const int fd = primary && multi && type == FRUIT;

  // --- Phase 3: kill credit and tail chase ---
  const unsigned eaters = __ballot_sync(kFull, eats);
  const int kc_owner = kc ? owner : -1;
  int kills = 0, dies_chase = 0;
  unsigned onto_my_tail = 0;  // snakes whose target is my old tail
  for (int j = 0; j < N; ++j) {
    const unsigned kj = __shfl_sync(kFull, key, j);
    const unsigned tj = __shfl_sync(kFull, tail_key, j);
    kills += __shfl_sync(kFull, kc_owner, j) == lane;
    if (kj == tail_key) onto_my_tail |= 1u << j;
    if (((eaters >> j) & 1u) && key == tj) dies_chase = 1;
  }
  const int chased = eats ? __popc(onto_my_tail & alive0) : 0;
  const float kd = static_cast<float>(kills + chased);
  const int dead = dcoll || (al0 && dies_chase);
  const int al1 = al0 && !dead;
  const unsigned alive1 = __ballot_sync(kFull, al1);
  // the reference decrements per chaser, on top of a phase-2 death
  const int acount = acount0 - __reduce_add_sync(kFull, dcoll + chased);
  const int taken = __reduce_add_sync(kFull, fd + eats);

  // --- Phases 4, 5, 8: win, rewards, stats, dones, rank ---
  const int timeout = elen >= a.max_steps;
  const int win = acount == 1 && N > 1 && al1 && (alive1 & below) == 0;
  float rew = __fmul_rn(a.r_time, static_cast<float>(al1));
  rew = __fadd_rn(rew, __fmul_rn(a.r_fruit, static_cast<float>(eats)));
  rew = __fadd_rn(rew, __fmul_rn(a.r_lose, static_cast<float>(dead)));
  rew = __fadd_rn(rew, __fmul_rn(a.r_kill, kd));
  rew = __fadd_rn(rew, __fmul_rn(a.r_win, static_cast<float>(win)));
  const float fruits_stat = al0 ? static_cast<float>(eats) : 0.0f;
  const float kills_stat = al0 ? kd : 0.0f;
  if (!al0) rew = 0.0f;
  const float mask = __fsub_rn(1.0f, al1 ? 0.0f : 1.0f);
  const float epi_s = __fadd_rn(es, __fmul_rn(mask, rew));
  const float epi_st = __fadd_rn(est, mask);
  const float epi_f = __fadd_rn(ef, __fmul_rn(mask, fruits_stat));
  const float epi_k = __fadd_rn(ek, __fmul_rn(mask, kills_stat));
  const int done = !al1 || timeout;
  const unsigned snakes = N == 32 ? kFull : (1u << N) - 1u;
  const unsigned dones = __ballot_sync(kFull, snake && done);
  const int done_all = a.any_mode ? dones != 0 : dones == snakes;
  const bool reset_now = kReset && done_all;
  int rank = 1;
  for (int j = 0; j < N; ++j) rank += __shfl_sync(kFull, epi_s, j) > epi_s;

  // Either the step's own grid and rings or a fresh reset's; the branch is
  // uniform across the warp.
  int nhr = hr, nhc = hc, ntr = tlr, ntc = tlc, al_out = al1;
  uint32_t* myr = ring + lane * CW;
  if (!reset_now) {
    // --- Phase 6: erase dead bodies, ring push/pop, cell writes ---
    const unsigned dead_mask = __ballot_sync(kFull, snake && dead);
    if (dead_mask) {
      for (int c = lane; c < HW; c += 32) {
        const int v = g[c], o = v >> OWNER_SHIFT;
        if ((v & 15) >= HEAD && o < N && ((dead_mask >> o) & 1u)) g[c] = EMPTY;
      }
    }
    const int retract = al1 && !eats;
    if (snake) {
      const int cap = a.cap;
      if (al1) {
        nrh = pmod(nrh - 1, cap);
        const int b0 = 2 * (nrh & 15);
        uint32_t& word = myr[nrh >> 4];
        word = (word & ~(3u << b0)) | (static_cast<uint32_t>(nd & 3) << b0);
        nrl += 1;
      }
      const int pidx = pmod(nrh + nrl - 1, cap);
      const int popped =
          static_cast<int>((myr[pidx >> 4] >> (2 * (pidx & 15))) & 3u);
      if (retract) {
        nrl -= 1;
        ntr = tlr + drow(popped);
        ntc = tlc + dcol(popped);
      }
      if (al1) {
        nhr = tr;
        nhc = tc;
      }
    }
    // a cell of -1 is a write that does not happen
    const int claimed = (onto_my_tail & alive1) != 0;
    const int head_flat = hr * W + hc, nt_flat = ntr * W + ntc;
    const int w_body =
        (al1 && !(retract && nt_flat == head_flat)) ? head_flat : -1;
    const int w_erase = (retract && !claimed) ? tlr * W + tlc : -1;
    const int w_head = al1 ? nhr * W + nhc : -1;
    const int w_tail = al1 ? nt_flat : -1;
    __syncwarp();  // erase done
    for (int kind = 0; kind < 4; ++kind) {
      const int mine = kind == 0 ? w_body
                     : kind == 1 ? w_erase
                     : kind == 2 ? w_head : w_tail;
      const int base = kind == 0 ? BODY
                     : kind == 1 ? EMPTY
                     : kind == 2 ? HEAD : TAIL;
      for (int j = 0; j < N; ++j) {
        const int c = __shfl_sync(kFull, mine, j);
        if (lane == 0 && c >= 0 && c < HW)
          g[c] = kind == 1 ? EMPTY : base + (j << OWNER_SHIFT);
      }
    }
  } else {
    // --- fused auto-reset: the snakes' paths, painted, and their rings ---
    // Path cell j of my snake, head first: row `row` of the pool, or the
    // procedural spawn's straight segment start + j * stride.
    const int32_t* mine = nullptr;
    int start = 0, stride = 0;
    if (a.procedural) {
      for (int c = lane; c < HW; c += 32) {
        const int r = c / W, col = c - r * W;
        g[c] = (r == 0 || r == H - 1 || col == 0 || col == W - 1) ? WALL : EMPTY;
      }
      if (snake) {
        const float* u = a.reset_spawn_u + static_cast<size_t>(e) * 4;
        const float u_pos = __ldg(u), u_col = __ldg(u + 1);
        const bool head_first = __ldg(u + 2) < 0.5f;  // head left, or on top
        const int band = (H - 2) / N, band0 = 1 + lane * band;
        if (a.vertical && __ldg(u + 3) < 0.5f) {
          const int r0 = band0 + pick(u_pos, band - K + 1);
          const int cv = 1 + pick(u_col, W - 2);
          start = (head_first ? r0 : r0 + K - 1) * W + cv;
          stride = head_first ? W : -W;
        } else {
          const int c0 = 1 + pick(u_col, W - 1 - K);
          start = (band0 + pick(u_pos, band)) * W + (head_first ? c0 : c0 + K - 1);
          stride = head_first ? 1 : -1;
        }
      }
    } else {
      const int row = pick(spawn_u, a.P);
      mine = a.pool_cells + (static_cast<size_t>(row) * N + lane) * K;
      copy_in(g, a.base_grid, HW, lane);
    }
    if (snake)
      for (int x = 0; x < CW; ++x) myr[x] = 0u;
    cp_async_wait_all();
    __syncwarp();
    if (snake) {
      // paths are disjoint across snakes: body, then head, then tail
      const int id = lane << OWNER_SHIFT;
      const int first = mine ? __ldg(mine) : start;
      int prev = first;
      g[first] = BODY + id;
      for (int j = 1; j < K; ++j) {
        const int c = mine ? __ldg(mine + j) : start + j * stride;
        g[c] = BODY + id;
        const uint32_t dj = static_cast<uint32_t>(flat_delta_to_dir(prev - c, W));
        myr[(j - 1) >> 4] |= dj << (2 * ((j - 1) & 15));
        if (j == 1) nd = static_cast<int>(dj);
        prev = c;
      }
      g[first] = HEAD + id;
      g[prev] = TAIL + id;
      nhr = first / W;
      nhc = first % W;
      ntr = prev / W;
      ntc = prev % W;
      nrh = 0;
      nrl = K - 1;
      al_out = 1;
    }
  }
  __syncwarp();

  // --- Phase 7: fruits on the selected grid, with the selected draws ---
  const int count = reset_now ? a.NF : taken;
  int num_empty = 0;
  for (int base = 0; base < HW; base += 32) {
    const int c = base + lane;
    num_empty += __popc(__ballot_sync(kFull, c < HW && g[c] == EMPTY));
  }
  int target = -1;  // my draw's 1-based rank among the empty cells
  if (lane < count && num_empty > 0) {
    const float u = reset_now ? ru : fu;
    const int r = static_cast<int>(floorf(__fmul_rn(u, static_cast<float>(num_empty))));
    target = min(max(r, 0), num_empty - 1) + 1;
  }
  const int last = __reduce_max_sync(kFull, target);
  int fruit_cell = -1;
  for (int base = 0, before = 0; before < last; base += 32) {
    const int c = base + lane;
    const unsigned m = __ballot_sync(kFull, c < HW && g[c] == EMPTY);
    const int n = __popc(m);
    if (target > before && target <= before + n)
      fruit_cell = base + static_cast<int>(__fns(m, 0, target - before));
    before += n;
  }
  __syncwarp();
  if (fruit_cell >= 0) g[fruit_cell] = FRUIT;  // duplicate draws collapse
  __syncwarp();

  // --- writes ---
  copy_out(at<int32_t>(a, a.o_grid) + static_cast<size_t>(b) * HW, g, HW, lane);
  copy_out(at<int32_t>(a, a.o_ring) + static_cast<size_t>(b) * ncw,
           reinterpret_cast<const int*>(ring), ncw, lane);
  if (snake) {
    at<int32_t>(a, a.o_direction)[e] = nd;
    at<int32_t>(a, a.o_head)[2 * e] = nhr;
    at<int32_t>(a, a.o_head)[2 * e + 1] = nhc;
    at<int32_t>(a, a.o_tail)[2 * e] = ntr;
    at<int32_t>(a, a.o_tail)[2 * e + 1] = ntc;
    at<int32_t>(a, a.o_ring_head)[e] = nrh;
    at<int32_t>(a, a.o_ring_len)[e] = nrl;
    at<uint8_t>(a, a.o_alive)[e] = static_cast<uint8_t>(al_out);
    // the running stats restart where the episode ends, reset or not
    at<float>(a, a.o_epi_scores)[e] = done_all ? 0.0f : epi_s;
    at<float>(a, a.o_epi_steps)[e] = done_all ? 0.0f : epi_st;
    at<float>(a, a.o_epi_fruits)[e] = done_all ? 0.0f : epi_f;
    at<float>(a, a.o_epi_kills)[e] = done_all ? 0.0f : epi_k;
    at<float>(a, a.o_reward)[e] = rew;
    at<uint8_t>(a, a.o_done)[e] =
        static_cast<uint8_t>(a.any_mode ? (done_all || done) : done);
    at<int32_t>(a, a.o_rank)[e] = rank;
    at<float>(a, a.o_episode_scores)[e] = epi_s;
    at<float>(a, a.o_episode_steps)[e] = epi_st;
    at<float>(a, a.o_episode_fruits)[e] = epi_f;
    at<float>(a, a.o_episode_kills)[e] = epi_k;
  }
  if (lane == 0) {
    at<int32_t>(a, a.o_alive_count)[b] = reset_now ? N : acount;
    at<int32_t>(a, a.o_episode_length)[b] = reset_now ? 0 : elen;
    at<uint8_t>(a, a.o_done_all)[b] = static_cast<uint8_t>(done_all);
  }

  // the observation: the window around each head, or the whole grid (with
  // a frame stack its history first, then every cell's frames side by side)
  if (a.V) {
    const unsigned anchor = (snake && al_out) ? pack(nhr, nhc) : 0u;
    if (a.packed) store_windows<uint8_t>(a, g, b, lane, reset_now, anchor);
    else store_windows<uint2>(a, g, b, lane, reset_now, anchor);
    return;
  }
  if (a.FS == 1) {
    // v is 1, 2 or 4 cells of the shared-memory grid, aligned to its size
    store_planes(a, b, lane, HW, [&](int j0, auto& v) {
      constexpr int n = sizeof(v) / sizeof(int);
      if constexpr (n == 4) {
        const int4 t = *reinterpret_cast<const int4*>(g + j0);
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
      } else if constexpr (n == 2) {
        const int2 t = *reinterpret_cast<const int2*>(g + j0);
        v[0] = t.x, v[1] = t.y;
      } else {
        v[0] = g[j0];
      }
    });
    return;
  }
  store_hist(a, g, b, lane, reset_now);
  // Cell j of the run is frame j % FS (oldest first) of grid cell j / FS: the
  // newest frame, and every frame of an env just reset, is the state's own
  // grid g; frame FS-2 is the PRE-step grid and an older frame f past grid
  // f+1 of hist_grid, both in the input arena.
  const int FS = a.FS;
  const int32_t* in_grid = in<int32_t>(a, a.o_grid) + static_cast<size_t>(b) * HW;
  const int32_t* in_hist =
      in<int32_t>(a, a.o_hist_grid) + static_cast<size_t>(b) * (FS - 1) * HW;
  store_planes(a, b, lane, HW * FS, [&](int j0, auto& v) {
    constexpr int n = sizeof(v) / sizeof(int);
    int p = j0 / FS, f = j0 - p * FS;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      v[i] = (reset_now || f == FS - 1) ? g[p]
             : f == FS - 2              ? __ldg(in_grid + p)
                                        : __ldg(in_hist + (f + 1) * HW + p);
      if (++f == FS) {
        f = 0;
        ++p;
      }
    }
  });
}

__global__ void __launch_bounds__(kMaxWarps * 32, 4)
step_autoreset_kernel(const StepArgs a) {
  step_body<true>(a);
}

__global__ void __launch_bounds__(kMaxWarps * 32, 4)
step_noreset_kernel(const StepArgs a) {
  step_body<false>(a);
}

// Bytes of shared memory one env (one warp) takes: its grid and its rings,
// each rounded up to 16 bytes.
static size_t smem_per_env(const StepArgs& a) {
  return static_cast<size_t>((a.H * a.W + 3) / 4 + (a.N * a.CW + 3) / 4) * 16;
}

// The dynamic shared memory each entry was last allowed, by device: the
// attribute is set only when a launch needs more, so that a launch recorded
// into a CUDA graph after its first call makes no cudaFuncSetAttribute call.
constexpr int kMaxDevices = 64;
static size_t smem_allowed[2][kMaxDevices];

static int launch(void (*kernel)(const StepArgs), int entry,
                  const StepArgs* args, void* stream) {
  const size_t per_env = smem_per_env(*args);
  const int warps = static_cast<int>(
      per_env * kMaxWarps <= kMaxSmem ? kMaxWarps : kMaxSmem / per_env);
  if (warps == 0 || args->N > 32 || args->NF > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = warps * per_env;
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    size_t* allowed =
        device < kMaxDevices ? &smem_allowed[entry][device] : nullptr;
    if (allowed == nullptr || *allowed < smem) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      if (allowed != nullptr) *allowed = smem;
    }
  }
  const int blocks = (args->B + warps - 1) / warps;
  kernel<<<blocks, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      *args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int marlsnake_step_autoreset(const StepArgs* args, void* stream) {
  return launch(step_autoreset_kernel, 0, args, stream);
}

// The step without auto-reset; the four reset inputs of *args are not read,
// and `keep` may be null.
extern "C" int marlsnake_step(const StepArgs* args, void* stream) {
  return launch(step_noreset_kernel, 1, args, stream);
}

extern "C" const char* marlsnake_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
