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
// What bounds them on an H100: latency. masked_actions reads each snake's
// obs once (at the evaluator's 256 envs x 4 snakes of 20x20x8, 3.3 MB: ~1 us
// at 3.35 TB/s) and writes a few bytes a snake; its integer work (~16
// operations a cell to scan the obs, ~9 a board word a round of fill) takes
// about half that at the int32 rate (64 a clock on each SM, ~16.7 T/s). The
// standalone fill reads one byte a cell and does ~9 operations a board word
// a round. Both run a few us: one env takes about as long as 256, so the
// time is the chain of dependent steps in one block (a launch, one trip to
// device memory, the instructions of the scan, three barriers, the fills,
// the claims), and the design keeps it to one trip to device memory, then
// shared memory and registers.
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
//   passable word and an OR. The count is __popc and __reduce_add_sync.
// - reachable_count: one warp a board, 8 boards a block. Lane l reads its
//   rows' bytes, 4 a load where the rows are 4-byte aligned (a 20-byte row
//   is 5 loads, all out before the first use; the start goes out first),
//   turns each load into 4 bits with one multiply and fills.
// - masked_actions: one block an env, min(3N, 32) warps for boards up to
//   32 x 64 and 64 x 32 (fewer on wider ones, whose fills need more
//   registers), and one more for the claim board where there is one.
//   (1) Load: the env's obs is read once. A unit is 32 cells of a snake in
//   row-major order, lane l reading cell 32u + l as one 8-byte load (eight
//   single bytes where the cells or the strides are not 8-byte aligned), so
//   a unit is one run of addresses; the warps of a snake (three, two or
//   one, as many as fit) split its units, and a lane issues up to 8 loads
//   before the first use. Each unit becomes, by __ballot_sync, a word of
//   each of the snake's planes in shared memory, in the same row-major
//   order: deadly (channels 0, 2, 3, 4, 6, 7), other head (2), fruit (1)
//   and, for a snake whose direction is unknown, own body or tail (6, 7);
//   the channels are tested 4 at a time (the bytes of a 32-bit half of the
//   cell equal to 1). The lanes keep the first maximum of the head and the
//   tail plane (the largest value << 24 | (2^24 - 1 - index)), the length
//   and whether a head and a tail are there, and each warp leaves them in
//   the snake's record. The same pass loads q, the directions and the
//   active flags, and the claim warp turns the claim board into bit rows
//   as reachable_count reads a board.
//   (2) Vetoes: thread 3s + m takes move m of snake s, from shared memory
//   only: the head and the tail from the warps' keys, an unknown direction
//   from the own plane, the target, and the deadly, head-to-head and fruit
//   bits around it.
//   (3) Fills: warp w takes the (snake, move) boards w, w + warps, ... not
//   vetoed yet: the post-move board's rows from the deadly plane (the old
//   head set, the tail cleared unless the move eats, the target cleared),
//   filled from the clamped target.
//   (4) Claims: lane s of warp 0 takes snake s. In snake order, lane t takes
//   its best move left (the argmax with a strict > from move 0: the first
//   maximum, as torch.argmax and jnp.argmax take it; a NaN counts as the
//   maximum, as in torch) and hands the cell it claims to the later lanes,
//   which veto their moves onto that cell or onto a cell of the claim
//   board; then each lane writes its snake's outputs.
//   A block needs 112 bytes and a deadly plane (H x WPR words) a snake in
//   shared memory (what the wrapper checks); the other planes go there too
//   where they fit, else to scratch in device memory that the wrapper
//   allocates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFillWarps = 8;          // reachable_count: boards a block
constexpr int kBatch = 8;              // masked_actions: loads in flight
constexpr int kMaxSnakes = 32;
constexpr int kSmemDefault = 48 * 1024;
constexpr float kNegInf = -__builtin_huge_valf();

// A build flag for measurement only (chip_smoke.py --mask-phases):
// masked_actions returns after its first MARLSNAKE_MASK_PHASES phases.
#ifndef MARLSNAKE_MASK_PHASES
#define MARLSNAKE_MASK_PHASES 4
#endif

// masked_actions' warps a block, by the board words a lane holds: all 32
// where the fill's registers fit in 64 a thread, fewer where they need more
__host__ __device__ constexpr int max_warps(int words_a_lane) {
  return words_a_lane <= 4 ? 32 : words_a_lane <= 16 ? 16 : 8;
}

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

// The 0/1 bytes of x as bits 0-3 (byte i to bit i): each byte's bit lands
// in the top byte of the product, with no carry from the bytes below.
__device__ __forceinline__ uint32_t byte_bits(uint32_t x) {
  return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// Lane `lane`'s rows of an h x w board of 0/1 bytes as bit rows (rows and
// columns beyond the board 0): 4 bytes a load where vec4 (the board's rows
// are 4-byte aligned), else 1; all of a word's loads go out before the
// first use.
template <int RPL, int WPR>
__device__ __forceinline__ void board_rows(const uint8_t* board, int h, int w,
                                           bool vec4, int lane,
                                           uint32_t (&out)[RPL][WPR]) {
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
    const uint8_t* row = board + r * w;
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      uint32_t word = 0u;
      if (vec4) {
        uint32_t v[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int x = 32 * k + 4 * t;
          v[t] = r < h && x < w
                     ? *reinterpret_cast<const uint32_t*>(row + x) : 0u;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) word |= byte_bits(v[t]) << (4 * t);
      } else {
        for (int x = 32 * k; r < h && x < min(w, 32 * k + 32); ++x) {
          word |= static_cast<uint32_t>(row[x] != 0) << (x & 31);
        }
      }
      out[j][k] = word;
    }
  }
}

template <int RPL, int WPR>
__global__ void __launch_bounds__(kFillWarps * 32)
reachable_count_kernel(const uint8_t* __restrict__ passable,
                       const int32_t* __restrict__ start, int M, int H, int W,
                       int limit, int vec4, int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kFillWarps + (threadIdx.x >> 5);
  if (b >= M) return;   // the whole warp
  const int sy = start[2 * b], sx = start[2 * b + 1];   // out first
  uint32_t pass[RPL][WPR];
  board_rows<RPL, WPR>(passable + static_cast<size_t>(b) * H * W, H, W,
                       vec4 != 0, lane, pass);
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
  uint32_t* scratch;         // (E, 3N + 1, H, WPR) words for the planes
                             // beyond the deadly ones, or null: in shared
                             // memory
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

// One snake's record in shared memory, 112 bytes (the size the wrapper's
// shared-memory check counts). Written in (1) by the snake's warps (a slot
// each) and thread s, in (2) by threads 3s..3s+2, dead in (3) by the warp of
// the move's fill.
struct SnakeInfo {
  int head_key[3];           // (1): each warp's largest head key, unsigned
  int tail_key[3];           //      and tail key
  int cells[3];              //      own cells | kSawHead | kSawTail
  int q[3];                  //      Q-values, float bits
  int dir[2];                //      the direction handed in
  int active;
  int head_y, head_x;        // (2)
  int tail;                  //      tail cell, y * W + x
  int len;
  int exists;                //      kSawHead | kSawTail
  int dy, dx;                //      the direction the moves turn from
  int target[3];             //      clamped target, y << 16 | x
  int flags[3];              //      kInBoard | kEats | kDead
};

constexpr int kSawHead = 1 << 29, kSawTail = 1 << 30;
constexpr int kInBoard = 1, kEats = 2, kDead = 4;

// Bit 7 of byte i of a cell's word (channels 0-3, or 4-7)
constexpr uint32_t kByte0 = 0x80u, kByte1 = 0x8000u, kByte2 = 0x800000u,
                   kByte3 = 0x80000000u;

// The env's planes, `size` words apart. A snake's plane is the board's cells
// in row-major order, 32 a word (bit b of word u is cell 32u + b); the claim
// plane is H rows of WPR words.
struct Planes {
  uint32_t* deadly;          // N planes
  uint32_t* other_head;      // N planes
  uint32_t* fruit;           // N planes
  uint32_t* own;             // N planes: own body or tail
  uint32_t* claimed;         // 1 plane: claimed cells
  int size;                  // H * WPR
  int words;                 // words of a snake's plane: ceil(H * W / 32)
};

__device__ __forceinline__ bool in_board(int y, int x, int h, int w) {
  return y >= 0 && y < h && x >= 0 && x < w;
}

template <int WPR>
__device__ __forceinline__ bool bit_at(const uint32_t* plane, int y, int x) {
  return (plane[y * WPR + (x >> 5)] >> (x & 31)) & 1u;
}

// Cell `cell` of a snake's plane.
__device__ __forceinline__ bool flat_bit(const uint32_t* plane, int cell) {
  return (plane[cell >> 5] >> (cell & 31)) & 1u;
}

// Lane `lane`'s rows of the h x w board in the snake plane `flat` (`words`
// words) as bit rows; the columns past w hold the next row's cells.
template <int RPL, int WPR>
__device__ __forceinline__ void flat_rows(const uint32_t* flat, int words,
                                          int h, int w, int lane,
                                          uint32_t (&out)[RPL][WPR]) {
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      const int f = r * w + 32 * k, u = f >> 5;
      uint32_t word = 0u;
      if (r < h && 32 * k < w) {
        word = __funnelshift_r(flat[u], u + 1 < words ? flat[u + 1] : 0u,
                               f & 31);
      }
      out[j][k] = word;
    }
  }
}

// Channels 0-3 (x) and 4-7 (y) of a cell, channel i in byte i % 4.
__device__ __forceinline__ uint2 load_cell(const uint8_t* cell, bool vec8) {
  if (vec8) return *reinterpret_cast<const uint2*>(cell);
  uint2 v = make_uint2(0u, 0u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v.x |= static_cast<uint32_t>(cell[i]) << (8 * i);
    v.y |= static_cast<uint32_t>(cell[4 + i]) << (8 * i);
  }
  return v;
}

// Bit 7 of each byte of x that is 1, every other bit 0 (exact per byte: no
// carry crosses a byte).
__device__ __forceinline__ uint32_t ones(uint32_t x) {
  const uint32_t y = x ^ 0x01010101u;
  return ~(((y & 0x7f7f7f7fu) + 0x7f7f7f7fu) | y) & 0x80808080u;
}

// Warps a snake in (1): as many as split the block's warps evenly, at most 3.
__device__ __forceinline__ int warps_per_snake(int warps, int n) {
  return min(3, max(1, warps / n));
}

// (1) the load. A unit is 32 cells of a snake in row-major order, lane l
// reading cell 32u + l, so a warp's loads of a unit are one run of
// addresses. The warps of a snake split its units in runs (warp `part` of
// `wps` takes units part * run .. part * run + run - 1); a warp takes snakes
// w / wps, w / wps + warps / wps, ... (more than one only where an env has
// more snakes than the block has warps). A lane issues kBatch loads before
// the first use. The own plane is built only for a snake whose direction
// is unknown: only its probe reads it.
template <int RPL, int WPR>
__device__ __forceinline__ void load_snakes(const MaskArgs& a, int e,
                                            int lane, int warp, int warps,
                                            SnakeInfo* info,
                                            const Planes& p) {
  const int N = a.N, C = a.C, cells_a_board = a.H * a.W;
  const bool vec8 = a.vec8 != 0;
  const int wps = warps_per_snake(warps, N), part = warp % wps;
  const int run = (p.words + wps - 1) / wps;
  const int first = part * run;
  const int n = max(0, min(run, p.words - first));
  for (int s = warp / wps; s < N; s += warps / wps) {
    const int i = e * N + s;
    const bool need_own = a.dirs[2 * i] == 0 && a.dirs[2 * i + 1] == 0;
    const uint8_t* o = a.obs + e * a.s_env + s * a.s_snake;
    uint32_t* deadly = p.deadly + s * p.size + first;
    uint32_t* other = p.other_head + s * p.size + first;
    uint32_t* fruit = p.fruit + s * p.size + first;
    uint32_t* own = p.own + s * p.size + first;
    unsigned head_key = 0u, tail_key = 0u;
    int cells = 0;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      uint2 v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int cell = 32 * (first + j0 + i) + lane;
        v[i] = make_uint2(0u, 0u);
        if (j0 + i < n && cell < cells_a_board) {
          v[i] = load_cell(o + cell * C, vec8);
        }
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int j = j0 + i;
        if (j >= n) break;   // the same for the whole warp
        // a lane past the board loaded zeros: no channel is 1 there
        const uint32_t lo = ones(v[i].x), hi = ones(v[i].y);
        const uint32_t d = __ballot_sync(
            kFull, ((lo | hi) & (kByte0 | kByte2 | kByte3)) != 0);
        const uint32_t oh = __ballot_sync(kFull, (lo & kByte2) != 0);
        const uint32_t f = __ballot_sync(kFull, (lo & kByte1) != 0);
        if (lane == 0) deadly[j] = d;
        if (lane == 1) other[j] = oh;
        if (lane == 2) fruit[j] = f;
        if (need_own) {
          const uint32_t ob =
              __ballot_sync(kFull, (hi & (kByte2 | kByte3)) != 0);
          if (lane == 3) own[j] = ob;
        }
        const int cell = 32 * (first + j) + lane;
        if (cell < cells_a_board) {
          // the first maximum of the head (channel 5) and the tail (7)
          const unsigned rev = 0xffffffu - static_cast<unsigned>(cell);
          head_key = max(head_key, ((v[i].y << 16) & 0xff000000u) | rev);
          tail_key = max(tail_key, (v[i].y & 0xff000000u) | rev);
          cells += __popc(hi & (kByte1 | kByte2 | kByte3));
          if (hi & kByte1) cells |= kSawHead;
          if (hi & kByte3) cells |= kSawTail;
        }
      }
    }
    head_key = __reduce_max_sync(kFull, head_key);
    tail_key = __reduce_max_sync(kFull, tail_key);
    const unsigned seen = __reduce_or_sync(
        kFull, static_cast<unsigned>(cells & (kSawHead | kSawTail)));
    const unsigned len = __reduce_add_sync(
        kFull, static_cast<unsigned>(cells & (kSawHead - 1)));
    if (lane == 0) {
      info[s].head_key[part] = static_cast<int>(head_key);
      info[s].tail_key[part] = static_cast<int>(tail_key);
      info[s].cells[part] = static_cast<int>(len | seen);
    }
  }
}

// (1) the claim board of env e as the claim plane, by one warp.
template <int RPL, int WPR>
__device__ __forceinline__ void load_claims(const MaskArgs& a, int e,
                                            int lane, const Planes& p) {
  const int H = a.H, W = a.W;
  const uint8_t* board = a.claims + static_cast<int64_t>(e) * H * W;
  const bool vec4 = ((reinterpret_cast<uintptr_t>(a.claims) | W) & 3) == 0;
  uint32_t rows[RPL][WPR];
  board_rows<RPL, WPR>(board, H, W, vec4, lane, rows);
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      if (r < H) p.claimed[r * WPR + k] = rows[j][k];
    }
  }
}

// idx / w and idx % w for idx < 2^16 and w <= 256, with inv =
// ceil(2^24 / w): the error of inv times idx stays below 2^24, so the
// product's top bits are the quotient.
__device__ __forceinline__ int2 div_w(int idx, int w, unsigned inv) {
  const int q = static_cast<int>(__umulhi(static_cast<unsigned>(idx) << 8,
                                          inv));
  return make_int2(q, idx - q * w);
}

// (2) the vetoes of move m of snake s, one thread, from shared memory.
__device__ __forceinline__ void veto_move(const MaskArgs& a, int s, int m,
                                          int wps, unsigned inv,
                                          SnakeInfo* info, const Planes& p) {
  const int H = a.H, W = a.W;
  SnakeInfo& in = info[s];
  unsigned head_key = 0u, tail_key = 0u;
  int len = 0, seen = 0;
  for (int i = 0; i < wps; ++i) {
    head_key = max(head_key, static_cast<unsigned>(in.head_key[i]));
    tail_key = max(tail_key, static_cast<unsigned>(in.tail_key[i]));
    len += in.cells[i] & (kSawHead - 1);
    seen |= in.cells[i] & (kSawHead | kSawTail);
  }
  const int2 head = div_w(0xffffff - static_cast<int>(head_key & 0xffffffu),
                          W, inv);
  const int hy = head.x, hx = head.y;
  int dy = in.dir[0], dx = in.dir[1];
  if (dy == 0 && dx == 0) {
    // the first probe that finds an own body or tail cell next to the head
    // gives the direction; UP where none does
    dy = -1;
    dx = 0;
    const uint32_t* own = p.own + s * p.size;
    for (int i = 0; i < 4; ++i) {
      const int by = hy - kProbeY[i], bx = hx - kProbeX[i];
      if (in_board(by, bx, H, W) && flat_bit(own, by * W + bx)) {
        dy = kProbeY[i];
        dx = kProbeX[i];
        break;
      }
    }
  }
  const int my = m == 0 ? dy : m == 1 ? -dx : dx;
  const int mx = m == 0 ? dx : m == 1 ? dy : -dy;
  const int y = hy + my, x = hx + mx;
  const bool inb = in_board(y, x, H, W);
  const int ty = min(max(y, 0), H - 1), tx = min(max(x, 0), W - 1);
  bool dead = !inb;
  if (inb) {
    dead = flat_bit(p.deadly + s * p.size, ty * W + tx);
    // head-to-head: a 4-neighbour of the target holds an enemy head
    const uint32_t* other = p.other_head + s * p.size;
    for (int i = 0; i < 4; ++i) {
      const int ny = ty + kProbeY[i], nx = tx + kProbeX[i];
      if (in_board(ny, nx, H, W) && flat_bit(other, ny * W + nx)) dead = true;
    }
  }
  const bool eat = flat_bit(p.fruit + s * p.size, ty * W + tx);
  in.target[m] = ty << 16 | tx;
  in.flags[m] = (inb ? kInBoard : 0) | (eat ? kEats : 0) | (dead ? kDead : 0);
  if (m == 0) {
    in.head_y = hy;
    in.head_x = hx;
    in.tail = 0xffffff - static_cast<int>(tail_key & 0xffffffu);
    in.len = len;
    in.exists = seen;
    in.dy = dy;
    in.dx = dx;
  }
}

// (3) the fill of move m of snake s by one warp: vetoed when the space from
// the target on the post-move board is less than the length after the move.
template <int RPL, int WPR>
__device__ __forceinline__ void fill_move(const MaskArgs& a, int s, int m,
                                          int lane, unsigned inv,
                                          SnakeInfo* info, const Planes& p) {
  SnakeInfo& in = info[s];
  const int flags = in.flags[m];
  if (flags & kDead) return;   // the fill cannot change a vetoed move
  const int H = a.H, W = a.W;
  const int ty = in.target[m] >> 16, tx = in.target[m] & 0xffff;
  const int hy = in.head_y, hx = in.head_x;
  const int eat = (flags & kEats) != 0;
  const int need = in.len + eat;
  const bool clear_tail = (in.exists & kSawTail) && !eat;
  const int2 tail = div_w(in.tail, W, inv);
  uint32_t pass[RPL][WPR];
  flat_rows<RPL, WPR>(p.deadly + s * p.size, p.words, H, W, lane, pass);
#pragma unroll
  for (int j = 0; j < RPL; ++j) {
    const int r = lane * RPL + j;
#pragma unroll
    for (int k = 0; k < WPR; ++k) {
      uint32_t blocked = r < H ? pass[j][k] : kFull;
      // the old head is body now; the tail retracts unless the move eats;
      // the target is the new head
      if (r == hy && (hx >> 5) == k) blocked |= 1u << (hx & 31);
      if (clear_tail && r == tail.x && (tail.y >> 5) == k) {
        blocked &= ~(1u << (tail.y & 31));
      }
      if (r == ty && (tx >> 5) == k) blocked &= ~(1u << (tx & 31));
      pass[j][k] = ~blocked & col_mask(k, W);
    }
  }
  const int space = flood_count<RPL, WPR>(pass, ty, tx, min(a.limit, need),
                                          lane);
  if (lane == 0 && space < need) in.flags[m] = flags | kDead;
}

// (4) the claims, the argmax and the outputs by warp 0, lane s for snake s.
// Snake by snake, lane t takes the best move left to it and hands its
// cell to the lanes after it, which veto the moves that target that cell.
template <int WPR>
__device__ __forceinline__ void claim_moves(const MaskArgs& a, int e, int s,
                                            const SnakeInfo* info,
                                            const Planes& p) {
  const int H = a.H, W = a.W, N = a.N;
  const bool mine = s < N;
  const SnakeInfo& in = info[mine ? s : 0];
  float v[3];
  int target[3];   // the cell a claim would veto, or -1
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int flags = in.flags[m], ty = in.target[m] >> 16,
              tx = in.target[m] & 0xffff;
    const bool open = !(flags & kDead) && (flags & kInBoard);
    const bool dead = (flags & kDead) ||
                      (open && a.claims && bit_at<WPR>(p.claimed, ty, tx));
    v[m] = dead ? kNegInf : __int_as_float(in.q[m]);
    target[m] = open ? ty * W + tx : -1;
  }
  const bool head_exists = (in.exists & kSawHead) != 0;
  const bool active = in.active != 0;
  int act = 0;
  for (int t = 0; t < N; ++t) {
    int cell = -1;
    if (s == t) {
      float best = v[0];
#pragma unroll
      for (int m = 1; m < 3; ++m) {
        if (v[m] > best || (v[m] != v[m] && best == best)) {
          best = v[m];   // strict: a tie keeps the earlier move
          act = m;
        }
      }
      if (head_exists && active) {
        const int y = in.head_y + (act == 0   ? in.dy
                                   : act == 1 ? -in.dx
                                              : in.dx);
        const int x = in.head_x + (act == 0   ? in.dx
                                   : act == 1 ? in.dy
                                              : -in.dy);
        cell = min(max(y, 0), H - 1) * W + min(max(x, 0), W - 1);
      }
    }
    cell = __shfl_sync(kFull, cell, t);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      if (cell >= 0 && target[m] == cell) v[m] = kNegInf;
    }
  }
  if (!mine) return;
  const int i = e * N + s;
  const int my = act == 0 ? in.dy : act == 1 ? -in.dx : in.dx;
  const int mx = act == 0 ? in.dx : act == 1 ? in.dy : -in.dy;
  a.act[i] = active && head_exists ? act : 0;
  a.new_dir[2 * i] = active ? (head_exists ? my : 0) : in.dir[0];
  a.new_dir[2 * i + 1] = active ? (head_exists ? mx : 0) : in.dir[1];
  a.next_pos[2 * i] = in.head_y + my;
  a.next_pos[2 * i + 1] = in.head_x + mx;
  a.head_exists[i] = static_cast<uint8_t>(head_exists);
}

// SCRATCH: the planes beyond the deadly ones are in a.scratch (device
// memory), else in shared memory after the deadly planes.
template <int RPL, int WPR, bool SCRATCH>
__global__ void __launch_bounds__(32 * max_warps(RPL * WPR))
masked_actions_kernel(MaskArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = a.N, e = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  SnakeInfo* info = reinterpret_cast<SnakeInfo*>(smem);
  Planes p;
  p.size = a.H * WPR;
  p.words = (a.H * a.W + 31) / 32;
  p.deadly = reinterpret_cast<uint32_t*>(smem + sizeof(SnakeInfo) * N);
  uint32_t* extra =
      SCRATCH ? a.scratch + static_cast<size_t>(e) * (3 * N + 1) * p.size
              : p.deadly + N * p.size;
  p.other_head = extra;
  p.fruit = extra + N * p.size;
  p.own = extra + 2 * N * p.size;
  p.claimed = extra + 3 * N * p.size;

  if (MARLSNAKE_MASK_PHASES < 1) return;
  // (1) the per-snake inputs go out first and reach shared memory after
  // the boards' loads
  int q[3], dir[2], active;
  if (tid < N) {
    const int i = e * N + tid;
    for (int m = 0; m < 3; ++m) q[m] = __float_as_int(a.q[3 * i + m]);
    dir[0] = a.dirs[2 * i];
    dir[1] = a.dirs[2 * i + 1];
    active = a.active[i];
  }
  // the last warp takes the claim board, where there is one
  const int snake_warps = warps - (a.claims ? 1 : 0);
  if (warp < snake_warps) {
    load_snakes<RPL, WPR>(a, e, lane, warp, snake_warps, info, p);
  } else {
    load_claims<RPL, WPR>(a, e, lane, p);
  }
  if (tid < N) {
    SnakeInfo& in = info[tid];
    for (int m = 0; m < 3; ++m) in.q[m] = q[m];
    in.dir[0] = dir[0];
    in.dir[1] = dir[1];
    in.active = active;
  }
  __syncthreads();
  if (MARLSNAKE_MASK_PHASES < 2) return;
  const unsigned inv = (0x1000000u + a.W - 1) / a.W;
  if (tid < 3 * N) {
    veto_move(a, tid / 3, tid % 3, warps_per_snake(snake_warps, N), inv,
              info, p);
  }
  __syncthreads();
  if (MARLSNAKE_MASK_PHASES < 3) return;
  for (int t = warp; t < 3 * N; t += warps) {
    fill_move<RPL, WPR>(a, t / 3, t % 3, lane, inv, info, p);
  }
  __syncthreads();
  if (MARLSNAKE_MASK_PHASES < 4) return;
  if (warp == 0) claim_moves<WPR>(a, e, lane, info, p);
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

// Lets `kernel` take `bytes` of dynamic shared memory where that is more
// than the default.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kSmemDefault) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

struct LaunchReachable {
  const uint8_t* passable;
  const int32_t* start;
  int M, H, W, limit;
  int32_t* out;
  cudaStream_t stream;
  template <int R, int K>
  int operator()() const {
    const int blocks = (M + kFillWarps - 1) / kFillWarps;
    const int vec4 =
        reinterpret_cast<uintptr_t>(passable) % 4 == 0 && W % 4 == 0;
    reachable_count_kernel<R, K><<<blocks, kFillWarps * 32, 0, stream>>>(
        passable, start, M, H, W, limit, vec4, out);
    return static_cast<int>(cudaGetLastError());
  }
};

struct LaunchMask {
  const MaskArgs* args;
  cudaStream_t stream;
  template <int R, int K>
  int operator()() const {
    return args->scratch ? launch<R, K, true>() : launch<R, K, false>();
  }
  template <int R, int K, bool SCRATCH>
  int launch() const {
    const MaskArgs& a = *args;
    const int planes = SCRATCH ? a.N : 4 * a.N + 1;
    const int bytes = static_cast<int>(sizeof(SnakeInfo) * a.N +
                                       sizeof(uint32_t) * a.H * K * planes);
    const int rc = allow_smem(masked_actions_kernel<R, K, SCRATCH>, bytes);
    if (rc != 0) return rc;
    // 3N warps at most for the snakes, and one for the claim board
    const int claims = a.claims ? 1 : 0;
    const int warps = min(3 * a.N, max_warps(R * K) - claims) + claims;
    masked_actions_kernel<R, K, SCRATCH><<<a.E, warps * 32, bytes, stream>>>(
        a);
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
