// The safety mask of the masked DQN policies, as two entries of one library.
//
// reachable_count_kernel: the bounded flood fill (a reachable-space count) of
//   many boards in one launch. It replaces the JAX package's
//   marlsnake_tpu/ops/floodfill.py::reachable_count (:25-41), a fori_loop of
//   masked dilations that XLA fuses (XLA code, not a Pallas kernel). Its
//   plain PyTorch version is
//   marlsnake_torch/ops/floodfill.py::reachable_count_plain.
// masked_actions_kernel: the whole safety mask of a batch of envs in one
//   launch: every veto of each snake's three moves, the flood fill of each
//   move's post-move board, the masked argmax and the claims in snake order.
//   It replaces marlsnake_tpu/algo/evaluator.py::masked_actions (:131-155,
//   with masked_action_single :56-128), XLA code under jit(vmap(...)). Its
//   plain version is marlsnake_torch/ops/safety_mask.py::masked_actions_plain.
//
// Exactness. Every value is an integer or a boolean except the Q-values,
// which are only compared, so both entries equal their plain versions bit for
// bit. `limit` rounds of 4-neighbour dilation from the start cell, capped at
// `limit`, give min(|region|, limit), where the region is the start cell and
// the passable cells connected to it (ops/floodfill.py says why). So any
// order of growth that stays inside the region gives the same answer, and a
// fill may stop as soon as a round adds no cell or the count reaches the cap.
// The rounds here update the visited words in place, which only grows the
// set sooner. A move is vetoed when min(|region|, limit) < need, the snake's
// length after the move; that is min(|region|, min(limit, need)) < need, so
// the mask's fills stop at the smaller cap: a few rounds for a short snake.
//
// What bounds them on an H100: bytes, and at the main path's sizes latency.
// masked_actions reads each snake's obs once (at the evaluator's 256 envs x
// 4 snakes of 20x20x8, 3.3 MB: ~1 us at 3.35 TB/s) and writes a few bytes a
// snake; its integer work (~16 operations a cell to scan the obs, ~9 a
// board word a round of fill) takes about half that at the int32 rate (64
// a clock on each SM, ~16.7 T/s). The standalone fill reads one byte a cell
// and does ~9 operations a board word a round, fewer than its bytes take
// on the boards the mask builds (a few rounds each; more on open boards and
// wide ones). Both run a few us, latency-bound: the point of one launch is
// to replace the plain versions' ~578 small launches a step.
//
// Design.
// - A board is held by one warp as bit rows of 32-bit words: bit b of word k
//   of a row is column 32k + b; lane l holds rows l*RPL .. l*RPL + RPL - 1 in
//   registers, WPR words each. RPL (1, 2, 4, 7) and WPR (1, 2, 4, 8) are
//   template parameters, so boards up to 224 rows by 256 columns; a 20x20
//   board is one word on each of 20 lanes. A round is, for each word, two
//   shifts with the carries of the row's neighbouring words, the words of the
//   rows above and below (in registers, or one __shfl_up_sync or
//   __shfl_down_sync at a lane's first and last row), an AND with the
//   passable word and an OR. The count is __popc and __reduce_add_sync. The
//   fill uses no shared memory.
// - reachable_count: one warp a board, 8 boards a block.
// - masked_actions: one block an env, min(3N, 8) warps.
//   (1) Warp w scans the obs of snakes w, w + 8, ...: each lane reads its
//   rows' 8-byte cells into deadly bit rows (channels 0, 2, 3, 4, 6, 7) and
//   finds the head and the tail as the first maximum of their planes (one
//   __reduce_max_sync of value << 24 | (2^24 - 1 - index)) and the length.
//   The deadly rows with the old head set go to shared memory. Lane 0 then
//   infers an unknown direction, and computes the three moves' targets and
//   every veto except the fill and the claims.
//   (2) Warp w takes the (snake, move) boards w, w + 8, ... not vetoed yet:
//   the post-move board from shared memory (the tail cleared unless the move
//   eats, the target cleared), filled from the clamped target.
//   (3) Thread 0 walks the snakes in order: the claims (the initial claim
//   board, then the cells claimed so far, a list of at most 32), the argmax
//   with a strict > from move 0 (the first maximum, as torch.argmax and
//   jnp.argmax take it; a NaN counts as the maximum, as in torch), and the
//   outputs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;              // warps a block, both entries
constexpr int kMaxSnakes = 32;
constexpr int kSmemDefault = 48 * 1024;
constexpr float kNegInf = -__builtin_huge_valf();

// obs channels (core/types.py)
constexpr int CH_WALL = 0, CH_FRUIT = 1, CH_OTHER_HEAD = 2, CH_OTHER_BODY = 3,
              CH_OTHER_TAIL = 4, CH_MY_HEAD = 5, CH_MY_BODY = 6,
              CH_MY_TAIL = 7;

// the reference's neighbour probe order (first match wins)
__constant__ int kProbeY[4] = {-1, 1, 0, 0};
__constant__ int kProbeX[4] = {0, 0, -1, 1};

// Word k's bits of the columns < w.
__device__ __forceinline__ uint32_t col_mask(int k, int w) {
  const int n = w - 32 * k;
  return n >= 32 ? kFull : (n <= 0 ? 0u : (1u << n) - 1u);
}

// min(|region|, cap) of the board `pass` from (sy, sx), which lies on the
// board: the region is the start cell (passable or not) and the passable
// cells connected to it. Every lane of the warp calls it with the same
// arguments; rows and columns outside the board must be 0 in `pass`.
template <int RPL, int WPR>
__device__ int flood_count(const uint32_t (&pass)[RPL][WPR], int sy, int sx,
                           int cap, int lane) {
  if (cap <= 1) return cap;   // the start alone reaches it
  uint32_t vis[RPL][WPR];
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      vis[j][k] = (lane * RPL + j == sy && (sx >> 5) == k)
                      ? (1u << (sx & 31)) : 0u;
    }
  }
  int total = 1;
  while (true) {
    // the rows next to this lane's first and last row, before the round
    uint32_t above[WPR], below[WPR];
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      above[k] = __shfl_up_sync(kFull, vis[RPL - 1][k], 1);
      below[k] = __shfl_down_sync(kFull, vis[0][k], 1);
      if (lane == 0) above[k] = 0u;
      if (lane == 31) below[k] = 0u;
    }
    int mine = 0;
#pragma unroll
    for (int j = 0; j < RPL; ++j) {
#pragma unroll
      for (int k = 0; k < WPR; ++k) {
        const uint32_t v = vis[j][k];
        uint32_t grow = (v << 1) | (v >> 1);
        if (k > 0) grow |= vis[j][k - 1] >> 31;
        if (k + 1 < WPR) grow |= vis[j][k + 1] << 31;
        grow |= j > 0 ? vis[j - 1][k] : above[k];
        grow |= j + 1 < RPL ? vis[j + 1][k] : below[k];
        vis[j][k] = v | (grow & pass[j][k]);
        mine += __popc(vis[j][k]);
      }
    }
    const int next = static_cast<int>(
        __reduce_add_sync(kFull, static_cast<unsigned>(mine)));
    if (next >= cap) return cap;
    if (next == total) return total;   // no cell added: the whole region
    total = next;
  }
}

// ---------------------------------------------------------------------------
// reachable_count

template <int RPL, int WPR>
__global__ void __launch_bounds__(kWarps * 32)
reachable_count_kernel(const uint8_t* __restrict__ passable,
                       const int32_t* __restrict__ start, int M, int H, int W,
                       int limit, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= M) return;   // the whole warp
  const uint8_t* board = passable + static_cast<size_t>(b) * H * W;
  uint32_t pass[RPL][WPR];
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      uint32_t word = 0u;
      if (r < H) {
        const int x1 = min(W, 32 * k + 32);
        for (int x = 32 * k; x < x1; ++x) {
          word |= static_cast<uint32_t>(board[r * W + x] != 0) << (x & 31);
        }
      }
      pass[j][k] = word;
    }
  }
  const int sy = start[2 * b], sx = start[2 * b + 1];
  int count;
  if (sy < 0 || sy >= H || sx < 0 || sx >= W) {
    count = min(0, limit);   // no start cell on the board (as in JAX)
  } else {
    count = flood_count<RPL, WPR>(pass, sy, sx, limit, lane);
  }
  if (lane == 0) out[b] = count;
}

}  // namespace

// Field order is mirrored by ctypes in marlsnake_torch/ops/mask_kernel.py;
// tests/test_torch_safety_mask.py parses this struct and checks the mirror.
struct MaskArgs {
  const uint8_t* obs;        // (E, N, H, W, C) uint8, channels 0-7 read;
                             // (H, W, C) dense, env and snake strides below
  const float* q;            // (E, N, 3) float32
  const int32_t* dirs;       // (E, N, 2) int32, (0, 0) unknown
  const uint8_t* active;     // (E, N) bool
  const uint8_t* claims;     // (E, H, W) bool claimed before snake 0, or null
  int32_t* act;              // (E, N) int32
  int32_t* new_dir;          // (E, N, 2) int32
  int32_t* next_pos;         // (E, N, 2) int32: head + the chosen move
  uint8_t* head_exists;      // (E, N) bool
  int64_t s_env;             // obs strides in bytes
  int64_t s_snake;
  int E;
  int N;
  int H;
  int W;
  int C;
  int limit;
  int vec8;                  // cells are 8-byte aligned: one load a cell
};

namespace {

// One snake's scan and vetoes, in shared memory.
struct SnakeInfo {
  int head_y, head_x, tail_y, tail_x;
  int head_exists, tail_exists;
  int len;
  int my[3], mx[3];          // the moves: straight, left, right
  int ty[3], tx[3];          // targets, clamped to the board
  int inb[3];                // the target is on the board
  int eat[3];                // fruit at the clamped target
  int dead[3];               // vetoed, claims aside
};

__device__ __forceinline__ bool in_board(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

__device__ __forceinline__ uint8_t channel(const uint8_t* obs, int y, int x,
                                           int w, int c, int ch) {
  return obs[(static_cast<int64_t>(y) * w + x) * c + ch];
}

__device__ __forceinline__ bool deadly_at(const uint8_t* o, int y, int x,
                                          int w, int c) {
  const uint8_t* cell = o + (static_cast<int64_t>(y) * w + x) * c;
  return cell[CH_WALL] == 1 || cell[CH_OTHER_HEAD] == 1 ||
         cell[CH_OTHER_BODY] == 1 || cell[CH_OTHER_TAIL] == 1 ||
         cell[CH_MY_BODY] == 1 || cell[CH_MY_TAIL] == 1;
}

// The 8 channels of cell (r, x) as bytes of one word (channel i = byte i).
__device__ __forceinline__ uint64_t load_cell(const uint8_t* o, int r, int x,
                                              int w, int c, bool vec8) {
  const uint8_t* cell = o + (static_cast<int64_t>(r) * w + x) * c;
  if (vec8) return *reinterpret_cast<const uint64_t*>(cell);
  uint64_t v = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) v |= static_cast<uint64_t>(cell[i]) << (8 * i);
  return v;
}

__device__ __forceinline__ unsigned byte_of(uint64_t v, int i) {
  return static_cast<unsigned>((v >> (8 * i)) & 0xff);
}

// (1) the scan of snake s by one warp, then lane 0's vetoes.
template <int RPL, int WPR>
__device__ void scan_snake(const MaskArgs& a, int e, int s, int lane,
                           uint32_t* base, SnakeInfo* info) {
  const int H = a.H, W = a.W, C = a.C;
  const bool vec8 = a.vec8 != 0;
  const uint8_t* o = a.obs + e * a.s_env + s * a.s_snake;
  uint32_t deadly[RPL][WPR];
  unsigned head_key = 0u, tail_key = 0u;
  bool head_one = false, tail_one = false;
  int len = 0;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      uint32_t word = 0u;
      if (r < H) {
        const int x1 = min(W, 32 * k + 32);
        for (int x = 32 * k; x < x1; ++x) {
          const uint64_t v = load_cell(o, r, x, W, C, vec8);
          const bool bad = byte_of(v, CH_WALL) == 1 ||
                           byte_of(v, CH_OTHER_HEAD) == 1 ||
                           byte_of(v, CH_OTHER_BODY) == 1 ||
                           byte_of(v, CH_OTHER_TAIL) == 1 ||
                           byte_of(v, CH_MY_BODY) == 1 ||
                           byte_of(v, CH_MY_TAIL) == 1;
          word |= static_cast<uint32_t>(bad) << (x & 31);
          const unsigned rev = 0xffffffu - static_cast<unsigned>(r * W + x);
          const unsigned hv = byte_of(v, CH_MY_HEAD);
          const unsigned tv = byte_of(v, CH_MY_TAIL);
          head_key = max(head_key, (hv << 24) | rev);
          tail_key = max(tail_key, (tv << 24) | rev);
          head_one |= hv == 1;
          tail_one |= tv == 1;
          len += (hv == 1) + (byte_of(v, CH_MY_BODY) == 1) + (tv == 1);
        }
      }
      deadly[j][k] = word;
    }
  }
  head_key = __reduce_max_sync(kFull, head_key);
  tail_key = __reduce_max_sync(kFull, tail_key);
  const bool head_exists = __any_sync(kFull, head_one);
  const bool tail_exists = __any_sync(kFull, tail_one);
  len = static_cast<int>(__reduce_add_sync(kFull, static_cast<unsigned>(len)));
  const int head = static_cast<int>(0xffffffu - (head_key & 0xffffffu));
  const int tail = static_cast<int>(0xffffffu - (tail_key & 0xffffffu));
  const int hy = head / W, hx = head % W;
  // the post-move board's blocked cells: the deadly ones and the old head
  uint32_t* rows = base + static_cast<size_t>(s) * H * WPR;
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
    if (r < H) {
#pragma unroll
      for (int k = 0; k < WPR; ++k) {
        uint32_t word = deadly[j][k];
        if (r == hy && (hx >> 5) == k) word |= 1u << (hx & 31);
        rows[r * WPR + k] = word;
      }
    }
  }
  if (lane != 0) return;

  SnakeInfo& in = info[s];
  in.head_y = hy;
  in.head_x = hx;
  in.tail_y = tail / W;
  in.tail_x = tail % W;
  in.head_exists = head_exists;
  in.tail_exists = tail_exists;
  in.len = len;
  int dy = a.dirs[(e * a.N + s) * 2], dx = a.dirs[(e * a.N + s) * 2 + 1];
  if (dy == 0 && dx == 0) {
    // the first probe that finds an own body or tail cell next to the head
    // gives the direction; UP where none does
    dy = -1;
    dx = 0;
    for (int p = 0; p < 4; ++p) {
      const int by = hy - kProbeY[p], bx = hx - kProbeX[p];
      if (in_board(by, bx, H, W) &&
          (channel(o, by, bx, W, C, CH_MY_BODY) == 1 ||
           channel(o, by, bx, W, C, CH_MY_TAIL) == 1)) {
        dy = kProbeY[p];
        dx = kProbeX[p];
        break;
      }
    }
  }
  const int my[3] = {dy, -dx, dx};
  const int mx[3] = {dx, dy, -dy};
  for (int m = 0; m < 3; ++m) {
    const int y = hy + my[m], x = hx + mx[m];
    const bool inb = in_board(y, x, H, W);
    const int ty = min(max(y, 0), H - 1), tx = min(max(x, 0), W - 1);
    bool dead = !inb;
    if (inb) {
      dead = deadly_at(o, ty, tx, W, C);
      // head-to-head: a 4-neighbour of the target holds an enemy head
      for (int p = 0; p < 4; ++p) {
        const int ny = ty + kProbeY[p], nx = tx + kProbeX[p];
        if (in_board(ny, nx, H, W) &&
            channel(o, ny, nx, W, C, CH_OTHER_HEAD) == 1) {
          dead = true;
        }
      }
    }
    in.my[m] = my[m];
    in.mx[m] = mx[m];
    in.ty[m] = ty;
    in.tx[m] = tx;
    in.inb[m] = inb;
    in.eat[m] = channel(o, ty, tx, W, C, CH_FRUIT) == 1;
    in.dead[m] = dead;
  }
}

// (2) the fill of move m of snake s by one warp: vetoed when the space from
// the target on the post-move board is less than the length after the move.
template <int RPL, int WPR>
__device__ void fill_move(const MaskArgs& a, int s, int m, int lane,
                          const uint32_t* base, SnakeInfo* info) {
  SnakeInfo& in = info[s];
  if (in.dead[m]) return;   // the fill cannot change a vetoed move
  const int H = a.H, W = a.W;
  const int ty = in.ty[m], tx = in.tx[m];
  const int need = in.len + in.eat[m];
  const bool clear_tail = in.tail_exists && !in.eat[m];
  const uint32_t* rows = base + static_cast<size_t>(s) * H * WPR;
  uint32_t pass[RPL][WPR];
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      uint32_t blocked = r < H ? rows[r * WPR + k] : kFull;
      // the tail retracts unless the move eats; the target is the new head
      if (clear_tail && r == in.tail_y && (in.tail_x >> 5) == k) {
        blocked &= ~(1u << (in.tail_x & 31));
      }
      if (r == ty && (tx >> 5) == k) blocked &= ~(1u << (tx & 31));
      pass[j][k] = ~blocked & col_mask(k, W);
    }
  }
  const int space = flood_count<RPL, WPR>(pass, ty, tx, min(a.limit, need),
                                          lane);
  if (lane == 0 && space < need) in.dead[m] = 1;
}

__device__ __forceinline__ bool claimed_before(const int* cy, const int* cx,
                                               int n, int y, int x) {
  for (int i = 0; i < n; ++i) {
    if (cy[i] == y && cx[i] == x) return true;
  }
  return false;
}

template <int RPL, int WPR>
__global__ void __launch_bounds__(kWarps * 32)
masked_actions_kernel(MaskArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  SnakeInfo* info = reinterpret_cast<SnakeInfo*>(smem);
  uint32_t* base = reinterpret_cast<uint32_t*>(smem + sizeof(SnakeInfo) * a.N);
  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;

  for (int s = warp; s < a.N; s += warps) {
    scan_snake<RPL, WPR>(a, e, s, lane, base, info);
  }
  __syncthreads();
  for (int t = warp; t < 3 * a.N; t += warps) {
    fill_move<RPL, WPR>(a, t / 3, t % 3, lane, base, info);
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int H = a.H, W = a.W, N = a.N;
  const uint8_t* claims =
      a.claims ? a.claims + static_cast<int64_t>(e) * H * W : nullptr;
  int cy[kMaxSnakes], cx[kMaxSnakes];
  int claimed = 0;
  for (int s = 0; s < N; ++s) {
    const SnakeInfo& in = info[s];
    const int i = e * N + s;
    const float* q = a.q + i * 3;
    int act = 0;
    float best = 0.f;
    for (int m = 0; m < 3; ++m) {
      bool dead = in.dead[m];
      if (!dead && in.inb[m]) {
        const int y = in.ty[m], x = in.tx[m];
        dead = (claims && claims[y * W + x]) ||
               claimed_before(cy, cx, claimed, y, x);
      }
      const float v = dead ? kNegInf : q[m];
      if (m == 0) {
        best = v;
      } else if (v > best || (v != v && best == best)) {
        best = v;   // strict: a tie keeps the earlier move
        act = m;
      }
    }
    const int ny = in.head_y + in.my[act], nx = in.head_x + in.mx[act];
    const bool active = a.active[i] != 0;
    if (in.head_exists && active) {
      cy[claimed] = min(max(ny, 0), H - 1);
      cx[claimed] = min(max(nx, 0), W - 1);
      ++claimed;
    }
    const int out_act = in.head_exists ? act : 0;
    const int out_dy = in.head_exists ? in.my[act] : 0;
    const int out_dx = in.head_exists ? in.mx[act] : 0;
    a.act[i] = active ? out_act : 0;
    a.new_dir[2 * i] = active ? out_dy : a.dirs[2 * i];
    a.new_dir[2 * i + 1] = active ? out_dx : a.dirs[2 * i + 1];
    a.next_pos[2 * i] = ny;
    a.next_pos[2 * i + 1] = nx;
    a.head_exists[i] = static_cast<uint8_t>(in.head_exists);
  }
}

// Rows a lane and words a row of the smallest instance that holds the board.
__host__ int rows_per_lane(int h) {
  const int need = (h + 31) / 32;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 7 ? 7 : 0;
}

__host__ int words_per_row(int w) {
  const int need = (w + 31) / 32;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : need <= 8 ? 8 : 0;
}

// Calls f.template operator()<RPL, WPR>() for the board's instance; returns
// cudaErrorInvalidValue for a board beyond 224 x 256.
template <typename F>
int dispatch(int h, int w, F f) {
  const int r = rows_per_lane(h), k = words_per_row(w);
#define MARLSNAKE_CASE(R, K) \
  if (r == R && k == K) return f.template operator()<R, K>();
#define MARLSNAKE_ROWS(R)                                       \
  MARLSNAKE_CASE(R, 1) MARLSNAKE_CASE(R, 2) MARLSNAKE_CASE(R, 4) \
  MARLSNAKE_CASE(R, 8)
  MARLSNAKE_ROWS(1) MARLSNAKE_ROWS(2) MARLSNAKE_ROWS(4) MARLSNAKE_ROWS(7)
#undef MARLSNAKE_ROWS
#undef MARLSNAKE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

struct LaunchReachable {
  const uint8_t* passable;
  const int32_t* start;
  int M, H, W, limit;
  int32_t* out;
  cudaStream_t stream;
  template <int R, int K>
  int operator()() const {
    const int blocks = (M + kWarps - 1) / kWarps;
    reachable_count_kernel<R, K><<<blocks, kWarps * 32, 0, stream>>>(
        passable, start, M, H, W, limit, out);
    return static_cast<int>(cudaGetLastError());
  }
};

struct LaunchMask {
  const MaskArgs* args;
  cudaStream_t stream;
  template <int R, int K>
  int operator()() const {
    const MaskArgs& a = *args;
    const int bytes = static_cast<int>(sizeof(SnakeInfo) * a.N +
                                       sizeof(uint32_t) * a.H * K * a.N);
    if (bytes > kSmemDefault) {
      const cudaError_t rc = cudaFuncSetAttribute(
          masked_actions_kernel<R, K>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    const int warps = min(3 * a.N, kWarps);
    masked_actions_kernel<R, K><<<a.E, warps * 32, bytes, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
};

}  // namespace

// out[b] = min(|region of board b from start b|, limit) for M boards of
// H x W (bool, contiguous), starts (M, 2) int32.
extern "C" int marlsnake_reachable_count(const uint8_t* passable,
                                         const int32_t* start, int M, int H,
                                         int W, int limit, int32_t* out,
                                         void* stream) {
  if (M == 0) return 0;
  return dispatch(H, W, LaunchReachable{passable, start, M, H, W, limit, out,
                                        static_cast<cudaStream_t>(stream)});
}

extern "C" int marlsnake_masked_actions(const MaskArgs* args, void* stream) {
  if (args->E == 0) return 0;
  if (args->N < 1 || args->N > kMaxSnakes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(args->H, args->W,
                  LaunchMask{args, static_cast<cudaStream_t>(stream)});
}

extern "C" const char* marlsnake_mask_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
