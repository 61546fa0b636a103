// g1_tree_reduce: halving-tree reductions of G1 points, each in one launch.
//
// Replaces the level-by-level use of K2 (g1_add.cu, the port of
// fourier_tpu/ops/pallas_curve.py:_add_inc_kernel) in the bucket-reduction
// trees of fourier_tpu/ops/curve.py (tree_reduce_last, tree_reduce_axis).
// There every level was one launch, and below the widest level no launch
// filled a wave of the card: each level paid an add's latency, a launch
// and the wrapper's host time, 33 launches for one BGMW reduction.
//
// G independent groups of n leaves, each reduced to `to` roots, in one
// launch: block g owns group g.  One launch may carry up to TREE_MAX_TREES
// independent trees (each its own run of blocks), so trees that do not
// depend on each other share the card instead of following each other.
// The leaves are padded with identities to P = to << k lanes; at every
// level lane i takes lane i + half, the pairing of the reference's trees,
// so the roots equal theirs limb for limb.  The block keeps `lanes` (to
// << j, at most P) points in shared memory as packed 32-bit words (144
// bytes a point) and runs every level there, with a barrier between
// levels; only the roots are written.  Where P is wider, P = lanes <<
// fan_levels, and each shared lane i first takes, while loading, the
// subtree of the first fan_levels levels over the leaves i + m * lanes (m
// < 2^fan_levels), summed in the same order (a binary counter over m
// bit-reversed).  The caller picks `lanes`; the shared memory a block may
// have bounds it.
//
// Leaves are read through strides (a limb stride, two group strides and a
// leaf stride per coordinate), so sliced, reshaped and broadcast views
// reduce without a copy; leaves past n read as the identity.  Doubling
// lanes are counted into `collisions`.
//
// Bound: integer multiply throughput (16 Fp products an add) on the wide
// levels, add latency on the narrow ones: a tree of depth d costs at least
// d dependent adds.

#include "g1.cuh"

#define TREE_MAX_FAN_LEVELS 8
#define TREE_MAX_THREADS 256
#define TREE_MAX_TREES 4
#define TREE_DESC_WORDS 24

struct TreeCoord {
  const int64_t *p;
  int64_t limb, g0, g1, leaf;
};

struct TreeArgs {
  TreeCoord c[3];
  int64_t groups1;  // groups = groups0 x groups1, g = g0 * groups1 + g1
  int64_t n;        // leaves a group
  int64_t n_roots;  // groups x to: the stride of the outputs
  int64_t first_block;
  int32_t to, lanes, fan_levels;
  int64_t *out[3];
};

struct TreeBatch {
  TreeArgs t[TREE_MAX_TREES];
  int32_t count;
  unsigned long long *collisions;
};

__device__ __forceinline__ void load_coord(Fp &r, const TreeCoord &c, int64_t off) {
  const int64_t *src = c.p + off;
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    const uint32_t lo = (uint32_t)src[(2 * j) * c.limb];
    const uint32_t hi = (uint32_t)src[(2 * j + 1) * c.limb];
    r.w[j] = lo | (hi << 16);
  }
}

__device__ __forceinline__ void load_leaf(Jac &r, const TreeArgs &a, int64_t g0, int64_t g1,
                                          int64_t j) {
  if (j >= a.n) {
    fp_set_zero(r.x);
    fp_set_zero(r.y);
    fp_set_zero(r.z);
    return;
  }
  load_coord(r.x, a.c[0], g0 * a.c[0].g0 + g1 * a.c[0].g1 + j * a.c[0].leaf);
  load_coord(r.y, a.c[1], g0 * a.c[1].g0 + g1 * a.c[1].g1 + j * a.c[1].leaf);
  load_coord(r.z, a.c[2], g0 * a.c[2].g0 + g1 * a.c[2].g1 + j * a.c[2].leaf);
}

// Shared lanes: word w of lane i at w * lanes + i.
__device__ __forceinline__ void lane_store(uint32_t *s, int lanes, int i, const Jac &p) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    s[j * lanes + i] = p.x.w[j];
    s[(FP_WORDS + j) * lanes + i] = p.y.w[j];
    s[(2 * FP_WORDS + j) * lanes + i] = p.z.w[j];
  }
}

__device__ __forceinline__ void lane_load(Jac &p, const uint32_t *s, int lanes, int i) {
#pragma unroll
  for (int j = 0; j < FP_WORDS; j++) {
    p.x.w[j] = s[j * lanes + i];
    p.y.w[j] = s[(FP_WORDS + j) * lanes + i];
    p.z.w[j] = s[(2 * FP_WORDS + j) * lanes + i];
  }
}

__global__ void __launch_bounds__(TREE_MAX_THREADS) g1_tree_kernel(const TreeBatch batch) {
  extern __shared__ uint32_t smem[];
  int k = 0;
  while (k + 1 < batch.count && (int64_t)blockIdx.x >= batch.t[k + 1].first_block) k++;
  const TreeArgs &a = batch.t[k];
  const int64_t g = blockIdx.x - a.first_block;
  const int64_t g0 = g / a.groups1, g1 = g % a.groups1;
  const int lanes = a.lanes;
  unsigned long long doubled = 0ull;

  for (int i = threadIdx.x; i < lanes; i += blockDim.x) {
    Jac v;
    if (a.fan_levels == 0) {
      load_leaf(v, a, g0, g1, i);
    } else {
      // Leaf t of the subtree in addition order is m = bitrev(t); a
      // completed left sibling of size 2^l waits in stack[l].
      Jac stack[TREE_MAX_FAN_LEVELS];
      const int fan = 1 << a.fan_levels;
      for (int t = 0; t < fan; t++) {
        const int m = (int)(__brev((unsigned)t) >> (32 - a.fan_levels));
        load_leaf(v, a, g0, g1, i + (int64_t)m * lanes);
        int l = 0;
        for (; (t >> l) & 1; l++) doubled += g1_add(v, stack[l], v);
        if (t + 1 < fan) stack[l] = v;
      }
    }
    lane_store(smem, lanes, i, v);
  }
  __syncthreads();

  for (int width = lanes; width > a.to; width >>= 1) {
    const int half = width >> 1;
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      Jac p, q;
      lane_load(p, smem, lanes, i);
      lane_load(q, smem, lanes, i + half);
      doubled += g1_add(p, p, q);
      lane_store(smem, lanes, i, p);
    }
    __syncthreads();
  }

  for (int i = threadIdx.x; i < a.to; i += blockDim.x) {
    Jac r;
    lane_load(r, smem, lanes, i);
    store_jac(a.out[0], a.out[1], a.out[2], a.n_roots, g * a.to + i, r);
  }
  if (doubled) atomicAdd(batch.collisions, doubled);
}

// desc: TREE_DESC_WORDS int64 a tree: the x, y, z and root x, y, z
// pointers; strides (limb, group 0, group 1, leaf) for x, y and z; groups0,
// groups1, n, to, lanes, fan_levels.  The launch's blocks have `threads`
// threads and room for the widest tree's lanes.
extern "C" int fk_g1_tree_reduce(int32_t count, const int64_t *desc, int32_t threads,
                                 void *collisions, void *stream) {
  if (count < 1 || count > TREE_MAX_TREES || threads < 32 || threads > TREE_MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  TreeBatch batch;
  batch.count = count;
  batch.collisions = (unsigned long long *)collisions;
  int64_t blocks = 0;
  int lanes_max = 0;
  for (int t = 0; t < count; t++) {
    const int64_t *d = desc + t * TREE_DESC_WORDS;
    TreeArgs &a = batch.t[t];
    for (int k = 0; k < 3; k++) {
      a.c[k].p = (const int64_t *)d[k];
      a.out[k] = (int64_t *)d[3 + k];
      a.c[k].limb = d[6 + 4 * k];
      a.c[k].g0 = d[7 + 4 * k];
      a.c[k].g1 = d[8 + 4 * k];
      a.c[k].leaf = d[9 + 4 * k];
    }
    const int64_t groups = d[18] * d[19];
    a.groups1 = d[19];
    a.n = d[20];
    a.to = (int32_t)d[21];
    a.lanes = (int32_t)d[22];
    a.fan_levels = (int32_t)d[23];
    a.n_roots = groups * a.to;
    a.first_block = blocks;
    // lanes = to << j, and lanes << fan_levels covers the n leaves
    const int64_t ratio = a.to > 0 ? a.lanes / a.to : 0;
    if (groups < 1 || a.to < 1 || a.lanes % a.to || ratio < 1 || (ratio & (ratio - 1)) ||
        a.fan_levels < 0 || a.fan_levels > TREE_MAX_FAN_LEVELS ||
        ((int64_t)a.lanes << a.fan_levels) < a.n)
      return (int)cudaErrorInvalidValue;
    blocks += groups;
    lanes_max = a.lanes > lanes_max ? a.lanes : lanes_max;
  }
  const size_t bytes = (size_t)lanes_max * 3 * FP_WORDS * sizeof(uint32_t);
  cudaError_t rc = cudaFuncSetAttribute(g1_tree_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return (int)rc;
  g1_tree_kernel<<<(unsigned int)blocks, threads, bytes, (cudaStream_t)stream>>>(batch);
  return (int)cudaGetLastError();
}
