// Gradient clipping by global norm and Adam over every leaf of a parameter
// set, as two kernels: the learners' whole optimizer step.
//
// Replaces optax.chain(clip_by_global_norm(max_norm), adam(lr)) as XLA
// compiled it for the JAX trainers (marlsnake_tpu/algo/dqn_trainer.py and
// marlsnake_tpu/algo/ppo_trainer.py), and with it the chain of PyTorch
// passes that computed it in the port: a foreach pass of squares, a sum a
// leaf, the clip's division, product and select, Adam's thirteen foreach
// passes, the parameters' add and the DQN's select of the kept update,
// each reading and writing the whole parameter set.
//
// The step is bound by bytes: each gradient is read once for the norm and
// once for the update, and the parameters and both moments are each read
// once and written once, about 28 bytes an element (6.6 M elements of the
// DQN take 186 MB, 55.5 us at 3.35 TB/s). Nothing here is worth computing
// twice to save a byte, so the design keeps every pass a stream:
//
// - sum_squares_kernel (pass 1): a grid of a few blocks an SM walks the
//   gradients' tiles with 16-byte loads and writes one float32 partial a
//   block. The first block of the first launch also writes the new Adam
//   count into scratch: the count plus the update flag.
// - adam_kernel (pass 2): every block sums all the partials in one fixed
//   order (so every block, and every run, holds the same norm) and takes
//   its square root, then walks the tiles of the parameters, moments and
//   gradients as pass 1 walked the gradients, in optax's arithmetic and
//   order (-fmad=false keeps each product and sum rounded on its own, as
//   PyTorch's separate passes round them):
//     g  = norm < max_norm ? g : (g / norm) * max_norm
//     m  = g * (1 - b1) + m * b1
//     v  = (g * g) * (1 - b2) + v * b2
//     u  = (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count)) + eps)
//     p  = p + u * (-lr)
//   with count the new count. An optional device flag folds the DQN's
//   "update only while the ring is warm" into the kernel: where it is 0
//   the outputs keep their inputs (nothing is written where they are the
//   inputs) and the count does not move.
//
// A tile is 1,024 elements of one leaf (256 threads, four each). Leaves
// of any size share the grid: a block finds a tile's leaf by a binary
// search of the tiles' prefix sum, which lies in the launch's argument
// block with the leaves' addresses, so that a captured CUDA graph replays
// the launches as they are and no table is copied to the device. Where
// the leaves outnumber one argument block (MAX_LEAVES) the launcher makes
// one launch of each kernel a chunk of leaves, all pass-1 launches first.
// A leaf whose seven arrays are not all 16-byte aligned is read and
// written an element at a time.

#include <cstdint>
#include <vector>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;           // threads a block
constexpr int VEC = 4;                 // elements a thread a tile
constexpr int TILE = THREADS * VEC;    // elements a tile
constexpr int MAX_LEAVES = 48;         // leaves one launch's arguments hold
constexpr int SUM_BLOCKS_PER_SM = 4;   // pass 1's grid: blocks an SM, at most

struct Leaves {
  const float* g[MAX_LEAVES];
  const float* p[MAX_LEAVES];
  const float* m[MAX_LEAVES];
  const float* v[MAX_LEAVES];
  float* po[MAX_LEAVES];
  float* mo[MAX_LEAVES];
  float* vo[MAX_LEAVES];
  long long n[MAX_LEAVES];
  long long first_tile[MAX_LEAVES + 1];  // prefix sum of the tiles
  unsigned long long vec;  // bit i: leaf i's arrays are all 16-byte aligned
  int count;               // leaves in this launch
};

struct Step {
  float* partials;         // pass 1's partials, every launch's in turn
  int* new_count;          // scratch: the count after this step
  const int* count_in;
  int* count_out;
  const unsigned char* flag;  // null: always update
  const float* norm;          // null: the norm of the partials
  int partial_base;        // this launch's first partial (pass 1)
  int n_partials;          // the partials of every launch (pass 2)
  int first;               // the first launch of its kernel
  int inplace;             // the outputs are the inputs
  float max_norm, b1, b2, c1, c2, eps, neg_lr;
};

static_assert(sizeof(Leaves) + sizeof(Step) <= 4096,
              "a launch's arguments must fit the 4 KB parameter space");

__device__ __forceinline__ int leaf_of(const Leaves& L, long long tile) {
  int lo = 0, hi = L.count - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (L.first_tile[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The block's sum of x, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warps[THREADS / 32];
  __shared__ float total;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) t += warps[w];
    total = t;
  }
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(THREADS)
sum_squares_kernel(const __grid_constant__ Leaves L,
                   const __grid_constant__ Step s) {
  if (s.first && blockIdx.x == 0 && threadIdx.x == 0) {
    *s.new_count = *s.count_in + (s.flag ? (*s.flag ? 1 : 0) : 1);
  }
  if (s.norm) return;
  float acc = 0.0f;
  const long long tiles = L.first_tile[L.count];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = leaf_of(L, t);
    const long long n = L.n[i];
    const long long e = (t - L.first_tile[i]) * TILE + threadIdx.x * VEC;
    const float* g = L.g[i];
    if (((L.vec >> i) & 1ull) && e + VEC <= n) {
      const float4 x = *reinterpret_cast<const float4*>(g + e);
      acc += x.x * x.x;
      acc += x.y * x.y;
      acc += x.z * x.z;
      acc += x.w * x.w;
    } else {
      for (int k = 0; k < VEC; ++k) {
        if (e + k < n) {
          const float x = g[e + k];
          acc += x * x;
        }
      }
    }
  }
  const float sum = block_sum(acc);
  if (threadIdx.x == 0) s.partials[s.partial_base + blockIdx.x] = sum;
}

struct Consts {
  float norm, max_norm, b1, b2, c1, c2, bc1, bc2, eps, neg_lr;
  bool clip;
};

__device__ __forceinline__ void adam_one(float g, float& p, float& m,
                                         float& v, const Consts& k) {
  if (k.clip) g = (g / k.norm) * k.max_norm;
  m = g * k.c1 + m * k.b1;
  v = (g * g) * k.c2 + v * k.b2;
  const float u = (m / k.bc1) / (sqrtf(v / k.bc2) + k.eps);
  p = p + u * k.neg_lr;
}

__global__ void __launch_bounds__(THREADS)
adam_kernel(const __grid_constant__ Leaves L,
            const __grid_constant__ Step s) {
  const bool update = s.flag ? (*s.flag != 0) : true;
  if (!update && s.inplace) return;
  const int count = *s.new_count;
  if (s.first && blockIdx.x == 0 && threadIdx.x == 0) *s.count_out = count;
  Consts k;
  if (update) {
    float norm;
    if (s.norm) {
      norm = *s.norm;
    } else {
      float acc = 0.0f;
      for (int j = threadIdx.x; j < s.n_partials; j += THREADS)
        acc += s.partials[j];
      norm = sqrtf(block_sum(acc));
    }
    k.norm = norm;
    k.max_norm = s.max_norm;
    k.clip = !(norm < s.max_norm);
    k.b1 = s.b1;
    k.b2 = s.b2;
    k.c1 = s.c1;
    k.c2 = s.c2;
    k.bc1 = 1.0f - powf(s.b1, static_cast<float>(count));
    k.bc2 = 1.0f - powf(s.b2, static_cast<float>(count));
    k.eps = s.eps;
    k.neg_lr = s.neg_lr;
  }
  const long long tiles = L.first_tile[L.count];
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int i = leaf_of(L, t);
    const long long n = L.n[i];
    const long long e = (t - L.first_tile[i]) * TILE + threadIdx.x * VEC;
    const float *g = L.g[i], *p = L.p[i], *m = L.m[i], *v = L.v[i];
    float *po = L.po[i], *mo = L.mo[i], *vo = L.vo[i];
    if (((L.vec >> i) & 1ull) && e + VEC <= n) {
      float4 pp = *reinterpret_cast<const float4*>(p + e);
      float4 mm = *reinterpret_cast<const float4*>(m + e);
      float4 vv = *reinterpret_cast<const float4*>(v + e);
      if (update) {
        const float4 gg = __ldcs(reinterpret_cast<const float4*>(g + e));
        adam_one(gg.x, pp.x, mm.x, vv.x, k);
        adam_one(gg.y, pp.y, mm.y, vv.y, k);
        adam_one(gg.z, pp.z, mm.z, vv.z, k);
        adam_one(gg.w, pp.w, mm.w, vv.w, k);
      }
      *reinterpret_cast<float4*>(po + e) = pp;
      *reinterpret_cast<float4*>(mo + e) = mm;
      *reinterpret_cast<float4*>(vo + e) = vv;
    } else {
      for (int j = 0; j < VEC; ++j) {
        const long long x = e + j;
        if (x >= n) break;
        float pp = p[x], mm = m[x], vv = v[x];
        if (update) adam_one(g[x], pp, mm, vv, k);
        po[x] = pp;
        mo[x] = mm;
        vo[x] = vv;
      }
    }
  }
}

int adam_blocks_per_sm() {
  static int blocks = 0;
  if (blocks == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, adam_kernel, THREADS, 0);
    if (err != cudaSuccess || blocks < 1) blocks = 1;
  }
  return blocks;
}

long long clamp_grid(long long tiles, long long most) {
  return tiles < 1 ? 1 : (tiles < most ? tiles : most);
}

}  // namespace

// One optimizer step over n leaves. ptrs holds seven addresses a leaf, in
// the order g, p, m, v, p_out, m_out, v_out; sizes the leaves' elements.
// scratch holds partial_capacity floats for pass 1's partials and, after
// them, the new count (an int32). flag (a bool) and norm (a float32) may
// be null. *launches receives the kernels launched (two a chunk of
// MAX_LEAVES leaves). Returns a cudaError_t, 0 when every launch was taken.
extern "C" int marlsnake_clip_adam(
    int n, const void* const* ptrs, const long long* sizes, float* scratch,
    int partial_capacity, const int* count_in, int* count_out,
    const unsigned char* flag, const float* norm, float max_norm, float b1,
    float b2, float c1, float c2, float eps, float neg_lr, int inplace,
    int sm_count, void* stream, int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  std::vector<Leaves> chunks;
  for (int first = 0; first < n; first += MAX_LEAVES) {
    Leaves L = {};
    L.count = n - first < MAX_LEAVES ? n - first : MAX_LEAVES;
    long long tiles = 0;
    for (int i = 0; i < L.count; ++i) {
      const void* const* a = ptrs + 7 * (first + i);
      L.g[i] = static_cast<const float*>(a[0]);
      L.p[i] = static_cast<const float*>(a[1]);
      L.m[i] = static_cast<const float*>(a[2]);
      L.v[i] = static_cast<const float*>(a[3]);
      L.po[i] = static_cast<float*>(const_cast<void*>(a[4]));
      L.mo[i] = static_cast<float*>(const_cast<void*>(a[5]));
      L.vo[i] = static_cast<float*>(const_cast<void*>(a[6]));
      bool aligned = true;
      for (int j = 0; j < 7; ++j)
        aligned = aligned && (reinterpret_cast<uintptr_t>(a[j]) % 16 == 0);
      if (aligned) L.vec |= 1ull << i;
      L.n[i] = sizes[first + i];
      L.first_tile[i] = tiles;
      tiles += (L.n[i] + TILE - 1) / TILE;
    }
    L.first_tile[L.count] = tiles;
    chunks.push_back(L);
  }
  Step s = {};
  s.new_count = reinterpret_cast<int*>(scratch + partial_capacity);
  s.count_in = count_in;
  s.count_out = count_out;
  s.flag = flag;
  s.norm = norm;
  s.inplace = inplace;
  s.max_norm = max_norm;
  s.b1 = b1;
  s.b2 = b2;
  s.c1 = c1;
  s.c2 = c2;
  s.eps = eps;
  s.neg_lr = neg_lr;
  float* partials = scratch;
  int base = 0;
  for (size_t c = 0; c < chunks.size(); ++c) {
    const long long tiles = chunks[c].first_tile[chunks[c].count];
    const int grid = norm ? 1 : static_cast<int>(clamp_grid(
        tiles, static_cast<long long>(sm_count) * SUM_BLOCKS_PER_SM));
    if (!norm && base + grid > partial_capacity)
      return static_cast<int>(cudaErrorInvalidValue);
    Step s1 = s;
    s1.partials = partials;
    s1.partial_base = base;
    s1.first = c == 0;
    sum_squares_kernel<<<grid, THREADS, 0, st>>>(chunks[c], s1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
    if (!norm) base += grid;
  }
  const long long most =
      static_cast<long long>(sm_count) * adam_blocks_per_sm();
  for (size_t c = 0; c < chunks.size(); ++c) {
    const int grid = static_cast<int>(clamp_grid(
        chunks[c].first_tile[chunks[c].count], most));
    Step s2 = s;
    s2.partials = partials;
    s2.n_partials = base;
    s2.first = c == 0;
    adam_kernel<<<grid, THREADS, 0, st>>>(chunks[c], s2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*launches;
  }
  return 0;
}

extern "C" const char* marlsnake_clip_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
