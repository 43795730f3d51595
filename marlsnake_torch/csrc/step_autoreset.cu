// Batched snake step with fused auto-reset and observation encode.
//
// Replaces the Pallas TPU kernel marlsnake_tpu/ops/pallas_step.py::_step_block
// (and the obs-encode epilogue of its launcher, build_pallas_step). The plain
// PyTorch version of the same function is marlsnake_torch/core/engine.py::
// step_autoreset; both take every random number as an input, so they agree
// bit for bit, floats included.
//
// What bounds it: bytes. Per env-step the kernel reads the state (grid H*W
// int32, the 2-bit rings, ~50 bytes per snake) and writes the new state plus
// the (N, H, W, 8) uint8 observation; at 20x20 with 4 snakes that is ~2.2 KB
// in and ~15 KB out, of which 12.8 KB is the observation. Its arithmetic is a
// few integer operations per byte, far below the card's rates.
//
// Design: one thread block per env, 128 threads. The env's grid, its rings
// and a prefix-count buffer live in shared memory, so the step touches device
// memory once to read the state and once to write the result. Per-snake
// phases (turn, collision, tail chase, rewards, ring push/pop) run on threads
// < N; grid passes (erase, reset paint, fruit placement, obs) are strided over
// the cells with __syncthreads() between phases. The obs is written as one
// 8-byte store per (snake, cell), consecutive threads on consecutive
// addresses. The fruit pick uses a block-wide prefix count of empty cells
// (warp shuffles). Cell writes that may overlap (old head, tail erase, new
// head, new tail) run in one thread in the engine's last-writer-wins order.
//
// Exactness: float sums use __fmul_rn/__fadd_rn in the engine's order (and
// the library is built with -fmad=false); ring bit work is on uint32_t; the
// ring index arithmetic is floor-modulo, as in PyTorch and JAX.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSnakes = 32;
constexpr int kMaxDraws = 32;

constexpr int EMPTY = 0, WALL = 1, FRUIT = 2, HEAD = 3, BODY = 4, TAIL = 5;
constexpr int OWNER_SHIFT = 4;
constexpr int UP = 0, RIGHT = 1, DOWN = 2, LEFT = 3;

}  // namespace

// Field order is mirrored by ctypes in marlsnake_torch/ops/step_kernel.py.
struct StepArgs {
  // inputs
  const int32_t* grid;       // (B, HW)
  const int32_t* dir;        // (B, N)
  const int32_t* head;       // (B, N, 2)
  const int32_t* tail;       // (B, N, 2)
  const int32_t* ring;       // (B, N, CW)
  const int32_t* ring_head;  // (B, N)
  const int32_t* ring_len;   // (B, N)
  const uint8_t* alive;      // (B, N) bool
  const int32_t* alive_count;  // (B,)
  const float* epi_scores;   // (B, N)
  const float* epi_steps;
  const float* epi_fruits;
  const float* epi_kills;
  const int32_t* episode_length;  // (B,)
  const int32_t* actions;    // (B, N)
  const float* fruit_u;      // (B, N)
  const float* reset_spawn_u;  // (B,)
  const float* reset_fruit_u;  // (B, NF)
  const int32_t* pool_cells;   // (P, N*K)
  const int32_t* base_grid;    // (HW,)
  // outputs: new state
  int32_t* o_grid;
  int32_t* o_dir;
  int32_t* o_head;
  int32_t* o_tail;
  int32_t* o_ring;
  int32_t* o_ring_head;
  int32_t* o_ring_len;
  uint8_t* o_alive;
  int32_t* o_alive_count;
  float* o_epi_scores;
  float* o_epi_steps;
  float* o_epi_fruits;
  float* o_epi_kills;
  int32_t* o_episode_length;
  // outputs: step output
  float* o_reward;
  uint8_t* o_done;
  int32_t* o_rank;
  float* o_io_scores;
  float* o_io_steps;
  float* o_io_fruits;
  float* o_io_kills;
  uint8_t* o_done_all;
  uint8_t* o_obs;  // (B, N, HW, 8)
  // shapes and config
  int B, H, W, N, K, NF, P, CW, cap;
  int human, any_mode, max_steps;
  float r_fruit, r_kill, r_lose, r_win, r_time;
};

__device__ __forceinline__ int pmod(int x, int m) { return ((x % m) + m) % m; }
__device__ __forceinline__ int drow(int d) { return (d == DOWN) - (d == UP); }
__device__ __forceinline__ int dcol(int d) { return (d == RIGHT) - (d == LEFT); }

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

__device__ __forceinline__ int flat_delta_to_dir(int d, int w) {
  return d == -w ? UP : (d == 1 ? RIGHT : (d == w ? DOWN : LEFT));
}

// Inclusive prefix count of EMPTY cells of g into cum; returns the total
// to every thread. All threads of the block must call it.
__device__ int empty_prefix_count(const int* g, int* cum, int hw,
                                  int* s_warp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int carry = 0;
  for (int base = 0; base < hw; base += kThreads) {
    const int c = base + tid;
    int x = (c < hw && g[c] == EMPTY) ? 1 : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    int off = carry, tot = 0;
#pragma unroll
    for (int w2 = 0; w2 < kThreads / 32; ++w2) {
      const int s = s_warp[w2];
      if (w2 < warp) off += s;
      tot += s;
    }
    if (c < hw) cum[c] = off + x;
    __syncthreads();
    carry += tot;
  }
  return carry;
}

__global__ void __launch_bounds__(kThreads)
step_autoreset_kernel(const StepArgs a) {
  extern __shared__ int smem[];
  const int H = a.H, W = a.W, HW = H * W, N = a.N, K = a.K, CW = a.CW;
  int* g = smem;                                        // HW
  int* cum = g + HW;                                    // HW
  uint32_t* ring = reinterpret_cast<uint32_t*>(cum + HW);  // N * CW

  __shared__ int s_tr[kMaxSnakes], s_tc[kMaxSnakes];
  __shared__ int s_tailr[kMaxSnakes], s_tailc[kMaxSnakes];
  __shared__ int s_owner[kMaxSnakes];
  __shared__ int s_alive0[kMaxSnakes], s_alive1[kMaxSnakes];
  __shared__ int s_dead[kMaxSnakes], s_eats[kMaxSnakes];
  __shared__ int s_kc[kMaxSnakes], s_fd[kMaxSnakes], s_dcoll[kMaxSnakes];
  __shared__ int s_chase[kMaxSnakes], s_done[kMaxSnakes];
  __shared__ float s_epi[kMaxSnakes];
  __shared__ int s_wcell[4 * kMaxSnakes], s_wval[4 * kMaxSnakes];
  __shared__ int s_wok[4 * kMaxSnakes];
  __shared__ int s_r[kMaxDraws];
  __shared__ int s_warp[kThreads / 32];
  __shared__ int s_acount, s_fruit_taken, s_done_all;

  const int b = blockIdx.x, tid = threadIdx.x;
  const bool snake = tid < N;
  const int i = tid, e = b * N + tid;

  for (int c = tid; c < HW; c += kThreads) g[c] = a.grid[(size_t)b * HW + c];
  for (int x = tid; x < N * CW; x += kThreads)
    ring[x] = static_cast<uint32_t>(a.ring[(size_t)b * N * CW + x]);

  // --- Phase 1: turn + proposed heads ---
  int d = 0, nd = 0, hr = 0, hc = 0, tr = 0, tc = 0, tlr = 0, tlc = 0;
  int type = 0, al0 = 0;
  if (snake) {
    d = a.dir[e];
    hr = a.head[2 * e];
    hc = a.head[2 * e + 1];
    tlr = a.tail[2 * e];
    tlc = a.tail[2 * e + 1];
    al0 = a.alive[e] != 0;
    nd = al0 ? next_dir(d, a.actions[e], a.human) : d;
    tr = hr + drow(nd);
    tc = hc + dcol(nd);
    s_tr[i] = tr;
    s_tc[i] = tc;
    s_tailr[i] = tlr;
    s_tailc[i] = tlc;
    s_alive0[i] = al0;
  }
  __syncthreads();  // grid, rings and targets loaded
  if (snake) {
    const int tf = tr * W + tc;
    const int cell = (tf >= 0 && tf < HW) ? g[tf] : 0;
    type = cell & 15;
    s_owner[i] = min(max(cell >> OWNER_SHIFT, 0), N - 1);
  }
  __syncthreads();

  // --- Phase 2: collision vs the pre-move grid ---
  int eats = 0;
  if (snake) {
    int count = 0, shared_lower = 0;
    for (int j = 0; j < N; ++j) {
      const int same = al0 && s_alive0[j] && s_tr[j] == tr && s_tc[j] == tc;
      count += same;
      if (j < i && same) shared_lower = 1;
    }
    const int multi = count >= 2;
    const int deadly = type == WALL || type == BODY || type == HEAD;
    const int primary = al0 && !shared_lower;
    eats = al0 && !multi && !deadly && type == FRUIT;
    s_dcoll[i] = al0 && (multi || deadly);
    s_kc[i] = primary && (type == BODY || type == HEAD);
    s_fd[i] = primary && multi && type == FRUIT;
    s_eats[i] = eats;
  }
  __syncthreads();

  // --- Phase 3: tail chase ---
  float kd = 0.0f;
  int dead = 0, al1 = 0;
  if (snake) {
    for (int j = 0; j < N; ++j)
      if (s_kc[j] && s_owner[j] == i) kd = __fadd_rn(kd, 1.0f);
    int chased = 0;  // chasers onto my old tail
    if (eats)
      for (int j = 0; j < N; ++j)
        chased += s_alive0[j] && s_tr[j] == tlr && s_tc[j] == tlc;
    kd = __fadd_rn(kd, static_cast<float>(chased));
    int dies_chase = 0;
    for (int f = 0; f < N; ++f)
      if (s_eats[f] && al0 && tr == s_tailr[f] && tc == s_tailc[f])
        dies_chase = 1;
    s_chase[i] = chased;
    dead = s_dcoll[i] || dies_chase;
    al1 = al0 && !dead;
    s_dead[i] = dead;
    s_alive1[i] = al1;
  }
  __syncthreads();
  if (tid == 0) {
    int acount = a.alive_count[b], taken = 0;
    for (int j = 0; j < N; ++j) {
      acount -= s_dcoll[j] + s_chase[j];
      taken += s_fd[j] + s_eats[j];
    }
    s_acount = acount;
    s_fruit_taken = taken;
  }
  __syncthreads();

  // --- Phases 4, 5, 8: win, rewards, stats, dones ---
  const int elen = a.episode_length[b] + 1;
  const int timeout = elen >= a.max_steps;
  float rew = 0.0f, epi_s = 0.0f, epi_st = 0.0f, epi_f = 0.0f, epi_k = 0.0f;
  if (snake) {
    int prior = 0;
    for (int j = 0; j < i; ++j) prior |= s_alive1[j];
    const int win = s_acount == 1 && N > 1 && al1 && !prior;
    rew = __fmul_rn(a.r_time, static_cast<float>(al1));
    rew = __fadd_rn(rew, __fmul_rn(a.r_fruit, static_cast<float>(eats)));
    rew = __fadd_rn(rew, __fmul_rn(a.r_lose, static_cast<float>(dead)));
    rew = __fadd_rn(rew, __fmul_rn(a.r_kill, kd));
    rew = __fadd_rn(rew, __fmul_rn(a.r_win, static_cast<float>(win)));
    const float fruits_stat = al0 ? static_cast<float>(eats) : 0.0f;
    const float kills_stat = al0 ? kd : 0.0f;
    if (!al0) rew = 0.0f;
    const float mask = __fsub_rn(1.0f, al1 ? 0.0f : 1.0f);
    epi_s = __fadd_rn(a.epi_scores[e], __fmul_rn(mask, rew));
    epi_st = __fadd_rn(a.epi_steps[e], mask);
    epi_f = __fadd_rn(a.epi_fruits[e], __fmul_rn(mask, fruits_stat));
    epi_k = __fadd_rn(a.epi_kills[e], __fmul_rn(mask, kills_stat));
    s_epi[i] = epi_s;
    s_done[i] = !al1 || timeout;
  }
  __syncthreads();
  if (tid == 0) {
    int any = 0, all = 1;
    for (int j = 0; j < N; ++j) {
      any |= s_done[j];
      all &= s_done[j];
    }
    s_done_all = a.any_mode ? any : all;
  }

  // --- Phase 6: erase dead bodies ---
  for (int c = tid; c < HW; c += kThreads) {
    const int v = g[c], t = v & 15, o = v >> OWNER_SHIFT;
    if (t >= HEAD && o < N && s_dead[o]) g[c] = EMPTY;
  }

  // ring push (alive) / pop (retracting), new head and tail
  int nrh = 0, nrl = 0, nhr = hr, nhc = hc, ntr = tlr, ntc = tlc;
  if (snake) {
    const int cap = a.cap;
    uint32_t* myr = ring + i * CW;
    nrh = a.ring_head[e];
    nrl = a.ring_len[e];
    if (al1) {
      nrh = pmod(nrh - 1, cap);
      const int b0 = 2 * (nrh & 15);
      uint32_t& word = myr[nrh >> 4];
      word = (word & ~(3u << b0)) | (static_cast<uint32_t>(nd & 3) << b0);
      nrl += 1;
    }
    const int retract = al1 && !eats;
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
    int claimed = 0;  // an alive mover targets my old tail
    for (int j = 0; j < N; ++j)
      claimed |= s_alive1[j] && s_tr[j] == tlr && s_tc[j] == tlc;
    const int head_flat = hr * W + hc, nt_flat = ntr * W + ntc;
    const int id = i << OWNER_SHIFT;
    s_wcell[i] = head_flat;
    s_wval[i] = BODY + id;
    s_wok[i] = al1 && !(retract && nt_flat == head_flat);
    s_wcell[N + i] = tlr * W + tlc;
    s_wval[N + i] = EMPTY;
    s_wok[N + i] = retract && !claimed;
    s_wcell[2 * N + i] = nhr * W + nhc;
    s_wval[2 * N + i] = HEAD + id;
    s_wok[2 * N + i] = al1;
    s_wcell[3 * N + i] = nt_flat;
    s_wval[3 * N + i] = TAIL + id;
    s_wok[3 * N + i] = al1;
  }
  __syncthreads();
  if (tid == 0) {
    for (int x = 0; x < 4 * N; ++x) {
      const int c = s_wcell[x];
      if (s_wok[x] && c >= 0 && c < HW) g[c] = s_wval[x];
    }
  }
  __syncthreads();

  // --- fused auto-reset (the branch is uniform across the block) ---
  const int done_all = s_done_all;
  int al_out = al1;
  if (done_all) {
    const int P = a.P;
    const int row =
        min(static_cast<int>(__fmul_rn(a.reset_spawn_u[b],
                                       static_cast<float>(P))), P - 1);
    const int32_t* cells = a.pool_cells + (size_t)row * N * K;
    for (int c = tid; c < HW; c += kThreads) g[c] = a.base_grid[c];
    __syncthreads();
    if (snake) {
      // paths are disjoint across snakes: body, then head, then tail
      const int32_t* mine = cells + i * K;
      const int id = i << OWNER_SHIFT;
      for (int j = 0; j < K; ++j) g[mine[j]] = BODY + id;
      g[mine[0]] = HEAD + id;
      g[mine[K - 1]] = TAIL + id;
      uint32_t* myr = ring + i * CW;
      for (int x = 0; x < CW; ++x) myr[x] = 0u;
      for (int j = 0; j < K - 1; ++j) {
        const uint32_t dj =
            static_cast<uint32_t>(flat_delta_to_dir(mine[j] - mine[j + 1], W));
        myr[j >> 4] |= dj << (2 * (j & 15));
        if (j == 0) nd = static_cast<int>(dj);
      }
      nhr = mine[0] / W;
      nhc = mine[0] % W;
      ntr = mine[K - 1] / W;
      ntc = mine[K - 1] % W;
      nrh = 0;
      nrl = K - 1;
      al_out = 1;
    }
  }
  __syncthreads();

  // --- Phase 7: fruits on the selected grid, with the selected draws ---
  const int count = done_all ? a.NF : s_fruit_taken;
  const int num_empty = empty_prefix_count(g, cum, HW, s_warp);
  if (tid < count) {
    const float u = done_all ? a.reset_fruit_u[(size_t)b * a.NF + tid]
                             : a.fruit_u[(size_t)b * N + tid];
    int r = static_cast<int>(floorf(__fmul_rn(u, static_cast<float>(num_empty))));
    r = min(max(r, 0), max(num_empty - 1, 0));
    s_r[tid] = num_empty > 0 ? r + 1 : -1;
  }
  __syncthreads();
  for (int c = tid; c < HW; c += kThreads) {
    if (g[c] != EMPTY) continue;
    for (int k = 0; k < count; ++k)
      if (cum[c] == s_r[k]) {
        g[c] = FRUIT;
        break;
      }
  }
  __syncthreads();

  // --- writes ---
  for (int c = tid; c < HW; c += kThreads) a.o_grid[(size_t)b * HW + c] = g[c];
  for (int x = tid; x < N * CW; x += kThreads)
    a.o_ring[(size_t)b * N * CW + x] = static_cast<int32_t>(ring[x]);
  if (snake) {
    int rank = 1;
    for (int j = 0; j < N; ++j) rank += s_epi[j] > epi_s;
    a.o_dir[e] = nd;
    a.o_head[2 * e] = nhr;
    a.o_head[2 * e + 1] = nhc;
    a.o_tail[2 * e] = ntr;
    a.o_tail[2 * e + 1] = ntc;
    a.o_ring_head[e] = nrh;
    a.o_ring_len[e] = nrl;
    a.o_alive[e] = static_cast<uint8_t>(al_out);
    a.o_epi_scores[e] = done_all ? 0.0f : epi_s;
    a.o_epi_steps[e] = done_all ? 0.0f : epi_st;
    a.o_epi_fruits[e] = done_all ? 0.0f : epi_f;
    a.o_epi_kills[e] = done_all ? 0.0f : epi_k;
    a.o_reward[e] = rew;
    a.o_done[e] = static_cast<uint8_t>(a.any_mode ? (done_all || s_done[i])
                                                  : s_done[i]);
    a.o_rank[e] = rank;
    a.o_io_scores[e] = epi_s;
    a.o_io_steps[e] = epi_st;
    a.o_io_fruits[e] = epi_f;
    a.o_io_kills[e] = epi_k;
  }
  if (tid == 0) {
    a.o_alive_count[b] = done_all ? N : s_acount;
    a.o_episode_length[b] = done_all ? 0 : elen;
    a.o_done_all[b] = static_cast<uint8_t>(done_all);
  }

  // observation: one little-endian 8-byte word per (snake, cell), byte c =
  // channel c: wall, fruit, other head/body/tail, my head/body/tail
  uint64_t* obs = reinterpret_cast<uint64_t*>(a.o_obs) + (size_t)b * N * HW;
  for (int x = tid; x < N * HW; x += kThreads) {
    const int s = x / HW, c = x - s * HW;
    const int v = g[c], t = v & 15;
    int bits = 0;
    if (t == WALL) bits = 1;
    else if (t == FRUIT) bits = 2;
    else if (t >= HEAD) bits = 1 << (2 + (t - HEAD) + ((v >> OWNER_SHIFT) == s ? 3 : 0));
    uint64_t word = 0;
#pragma unroll
    for (int ch = 0; ch < 8; ++ch)
      word |= static_cast<uint64_t>((bits >> ch) & 1) << (8 * ch);
    obs[x] = word;
  }
}

extern "C" int marlsnake_step_autoreset(const StepArgs* args, void* stream) {
  const size_t smem =
      (2 * static_cast<size_t>(args->H) * args->W +
       static_cast<size_t>(args->N) * args->CW) * sizeof(int);
  step_autoreset_kernel<<<args->B, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* marlsnake_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
