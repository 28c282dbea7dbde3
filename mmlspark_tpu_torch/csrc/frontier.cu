// Fused GBDT frontier step for Hopper (sm_90a): the two halves of the TPU
// kernel in mmlspark_tpu/ops/pallas_histogram.py (_make_kernel, launched by
// _frontier's pl.pallas_call), written as two CUDA kernels.
//
// hist_accumulate (replaces _make_kernel:199-238, the accumulation half)
//   The packed int32 lanes (C = 1..3, ops.histogram._pack_lanes) of every row
//   with node >= 0, summed per (node, feature, bin) into the zeroed
//   (C, N, F, B) output.  What bounds it: the bytes it must read (node ids,
//   then the active rows' bins and int8 gradients) against the issue rate of
//   shared-memory atomics, one per (active row, feature, field).  On sm_90 a
//   64-bit shared atomicAdd is a CAS loop (ATOMS.CAST.SPIN.64), so the block
//   keeps three int32 planes (Σqg, Σqh, count) and adds each with one native
//   ATOMS.ADD.  The design, part by part:
//   - a persistent grid of one 1024-thread block per SM, each with the SM's
//     shared memory, takes an even share of the (node group, feature group,
//     row) work, so no SM idles in a tail wave and a feature group is as wide
//     as the accumulator allows (fewer re-reads of node ids);
//   - each warp loads node ids and gradients of four 32-row chunks at once,
//     queues the rows of its node group by ballot and prefix count, and runs
//     the feature loop only on batches of 32 queued rows: every lane is live
//     at levels where most rows belong to no node of the step;
//   - the feature loop issues eight bin loads before their atomics;
//   - at the end of each segment (a block's rows of one group) the block adds
//     its non-zero cells to the output with global atomics, re-encoded in the
//     output lane layout: the lanes are linear in (qg, qh, 1), so wrapping
//     int32 sums of the re-encoded block sums equal the plain sums of packed
//     lanes mod 2^32, bit for bit, for any int8 gradients.
//   The binned matrix is read feature-major (s_row = 1): a 32-row batch of
//   one feature spans a sector or two.  An input whose rows all fall in one
//   bin serialises every atomic on one address (PERF.md has its cost).
//
// frontier_finish (replaces the _finish epilogue, :240-300, and the cross
//   feature-block reduction in _frontier, :424-429)
//   One launch per call.  A block takes one parent (or one node in direct
//   mode) and a group of at most 5 features, and emits both children.  Its
//   bound is bytes (the lane sums, the parent and both children: 2.4 MB,
//   0.75 us, at one parent of the bench), but its time is the latency of
//   a chain of dependent phases (PERF.md has them), so each phase keeps
//   its chain short:
//   - every global load of the block's cells is issued before any store;
//     decode the lane sums (floor div/mod done as arithmetic shifts and
//     masks: the lane terms are multiples of 2^cbits / 2^hbits, and all3
//     sums are negative whenever sum(qg) < 0), subtract the small child from
//     the parent in int32, store both children, and keep their integer sums
//     and dequantized f32 values in two shared planes;
//   - scan the bins in f32 from bin 0 upwards, one lane of warp 0 per
//     (child, channel, feature) chain, up to 30 chains at once, 32 bins at a
//     time through registers, so a chain is little more than its B
//     dependent adds; warp 1 meanwhile sums the integers, the exact totals;
//   - score every bin with l1/l2 and the gates (loaded with the cells), keep
//     the group's first maximum and leave it in a scratch row; the last
//     block of the parent to finish (an atomic counter per parent, which
//     that block resets to zero) takes the first maximum over the groups,
//     lowest feature first, which equals the flat first-max order of the
//     TPU kernel and of jnp.argmax.
//   The parent may be read, and the children written, in the leaf-wise
//   grower's carry, int16 or int32, at rows given by device indices: the
//   left child's row is the parent's own, which is safe because the thread
//   that reads a parent cell is the one that writes it.  Two outputs gated
//   to one trash row leave the second, as two writes in order would.  Every
//   float operation uses an explicit round-to-nearest intrinsic in the
//   plain version's order, so no multiply-add is contracted and the result
//   equals ops/cuda_histogram.py::frontier_finish_plain bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAccThreads = 1024;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kQueue = 64;     // per-warp queue of active rows (two batches)
constexpr int kRowChunks = 4;  // 32-row chunks whose loads a warp overlaps
constexpr int kFeatBatch = 8;  // bin loads in flight before their atomics
constexpr int kMaxBins = 256;
constexpr int kFinishThreads = 256;
constexpr int kFinishMaxFeat = 5;  // 2 outputs x 3 channels x 5: one warp
constexpr int kPart = 8;  // a block's partial best: gain i GL HL CL G H C

struct AccArgs {
  const uint8_t* binned;
  long long s_row, s_feat;
  const int8_t* qg;
  const int8_t* qh;
  const int32_t* node_ids;
  int32_t* out;  // (C, N, F, B), zeroed
  int n, F, B, N;
  int G, NG, Fg, Ng;       // feature / node groups and their widths
  int mode, cbits, hbits;  // the output lane layout
};

// One queued row into the block's three planes: per feature of the group,
// one native shared atomic per field.  meta = node << 16 | qg << 8 | qh.
__device__ __forceinline__ void add_row(const AccArgs& a, int32_t* acc,
                                        int plane, int row, uint32_t meta,
                                        int f0, int fcount) {
  const int qg = (int8_t)(meta >> 8);
  const int qh = (int8_t)meta;
  const uint8_t* p = a.binned + (long long)row * a.s_row +
                     (long long)f0 * a.s_feat;
  int32_t* cell = acc + (int)(meta >> 16) * a.Fg * a.B;
  for (int f = 0; f < fcount; f += kFeatBatch) {
    uint32_t b[kFeatBatch];
#pragma unroll
    for (int u = 0; u < kFeatBatch; ++u)  // 256: past the group's features
      b[u] = f + u < fcount ? __ldg(p + (long long)(f + u) * a.s_feat) : 256;
#pragma unroll
    for (int u = 0; u < kFeatBatch; ++u) {
      if (b[u] >= (uint32_t)a.B) continue;  // or a bin out of contract
      int32_t* c = cell + (f + u) * a.B + b[u];
      atomicAdd(c, qg);
      atomicAdd(c + plane, qh);
      atomicAdd(c + 2 * plane, 1);
    }
  }
}

__global__ void __launch_bounds__(kAccThreads, 1)
    hist_accumulate_kernel(const AccArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* q_row = reinterpret_cast<int32_t*>(smem);  // [warps][kQueue]
  uint32_t* q_meta = reinterpret_cast<uint32_t*>(q_row + kAccWarps * kQueue);
  int32_t* acc = reinterpret_cast<int32_t*>(q_meta + kAccWarps * kQueue);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* my_row = q_row + warp * kQueue;
  uint32_t* my_meta = q_meta + warp * kQueue;
  const unsigned lt = (1u << lane) - 1u;
  const int plane = a.Ng * a.Fg * a.B;  // (Ng, Fg, B) int32: Σqg, Σqh, count
  for (int i = threadIdx.x; i < 3 * plane; i += kAccThreads) acc[i] = 0;

  // this block's share of the (node group, feature group, row) work units
  const long long n = a.n;
  const long long units = (long long)a.G * a.NG * n;
  long long u = units * blockIdx.x / gridDim.x;
  const long long u_end = units * (blockIdx.x + 1) / gridDim.x;
  const long long out_plane = (long long)a.N * a.F * a.B;
  while (u < u_end) {  // one segment: this block's rows of one group
    const long long gi = u / n;
    const int r0 = (int)(u - gi * n);
    const int r1 = (int)min(n, r0 + (u_end - u));
    const int fgi = (int)(gi % a.G), ngi = (int)(gi / a.G);
    const int f0 = (int)((long long)fgi * a.F / a.G);
    const int fcount = (int)((long long)(fgi + 1) * a.F / a.G) - f0;
    const int g0 = ngi * a.Ng;
    const int gcount = min(a.Ng, a.N - g0);
    __syncthreads();  // the zeroed accumulator is visible to every warp

    int queued = 0;
    auto push = [&](bool live, int r, uint32_t meta) {
      const unsigned m = __ballot_sync(0xffffffffu, live);
      if (live) {
        const int pos = queued + __popc(m & lt);
        my_row[pos] = r;
        my_meta[pos] = meta;
      }
      queued += __popc(m);
      if (queued >= 32) {  // a full batch: 32 live rows through the features
        __syncwarp();
        add_row(a, acc, plane, my_row[lane], my_meta[lane], f0, fcount);
        __syncwarp();
        if (lane < queued - 32) {
          my_row[lane] = my_row[lane + 32];
          my_meta[lane] = my_meta[lane + 32];
        }
        __syncwarp();
        queued -= 32;
      }
    };
    for (int base = r0 + warp * 32; base < r1;
         base += kRowChunks * kAccThreads) {
      int id[kRowChunks];
      uint32_t q[kRowChunks];
#pragma unroll
      for (int k = 0; k < kRowChunks; ++k) {
        const int r = base + k * kAccThreads + lane;
        id[k] = -1;
        q[k] = 0;
        if (r < r1) {
          id[k] = __ldg(a.node_ids + r);
          q[k] = ((uint32_t)(uint8_t)__ldg(a.qg + r) << 8) |
                 (uint32_t)(uint8_t)__ldg(a.qh + r);
        }
      }
#pragma unroll
      for (int k = 0; k < kRowChunks; ++k) {
        const int g = id[k] - g0;  // node < 0 lands below 0
        push((unsigned)g < (unsigned)gcount, base + k * kAccThreads + lane,
             ((uint32_t)g << 16) | q[k]);
      }
    }
    __syncwarp();
    if (lane < queued)
      add_row(a, acc, plane, my_row[lane], my_meta[lane], f0, fcount);
    __syncthreads();

    // merge the non-zero cells in the output layout (wrapping uint32 math)
    // and zero them for the next segment
    for (int i = threadIdx.x; i < plane; i += kAccThreads) {
      const uint32_t cnt = acc[i + 2 * plane];
      if (cnt == 0) continue;
      const uint32_t sg = acc[i], sh = acc[i + plane];
      acc[i] = 0;
      acc[i + plane] = 0;
      acc[i + 2 * plane] = 0;
      const int b = i % a.B, t = i / a.B;
      const int f = t % a.Fg, g = t / a.Fg;
      int32_t* o = a.out + ((long long)(g0 + g) * a.F + f0 + f) * a.B + b;
      if (a.mode == 0) {  // all3: ((qg * KH) + qh) * KC + 1
        atomicAdd(o, (int32_t)((sg << (a.hbits + a.cbits)) +
                               (sh << a.cbits) + cnt));
      } else if (a.mode == 1) {  // 2ch: qg | qh * KC + 1
        atomicAdd(o, (int32_t)sg);
        atomicAdd(o + out_plane, (int32_t)((sh << a.cbits) + cnt));
      } else {  // wide: qg | qh | 1
        atomicAdd(o, (int32_t)sg);
        atomicAdd(o + out_plane, (int32_t)sh);
        atomicAdd(o + 2 * out_plane, (int32_t)cnt);
      }
    }
    u += r1 - r0;
  }
}

// the packed lane sums of one cell: 1, 2 or 3 planes by layout
__device__ __forceinline__ void load_lanes(const int32_t* acc,
                                           long long plane, long long idx,
                                           int mode, int* r) {
  r[0] = acc[idx];
  r[1] = mode >= 1 ? acc[plane + idx] : 0;
  r[2] = mode == 2 ? acc[2 * plane + idx] : 0;
}

// (qg_sum, qh_sum, count) of one cell from its packed lane sums
__device__ __forceinline__ void unpack(const int* r, int mode, int cbits,
                                       int hbits, int* q) {
  if (mode == 0) {  // all3: ((qg * KH) + qh) * KC + count
    q[2] = r[0] & ((1 << cbits) - 1);
    const int32_t s2 = r[0] >> cbits;
    q[1] = s2 & ((1 << hbits) - 1);
    q[0] = s2 >> hbits;
  } else if (mode == 1) {  // 2ch: qg | qh * KC + count
    q[0] = r[0];
    q[2] = r[1] & ((1 << cbits) - 1);
    q[1] = r[1] >> cbits;
  } else {  // wide
    q[0] = r[0];
    q[1] = r[1];
    q[2] = r[2];
  }
}

// first-max order of jnp.argmax / torch.argmax: larger wins, a NaN beats
// every number, and equal values (or two NaNs) go to the lower index
__device__ __forceinline__ bool better(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__device__ __forceinline__ float leaf_score(float G, float H, float l1,
                                            float l2) {
  const float sgn = G > 0.f ? 1.f : (G < 0.f ? -1.f : 0.f);
  const float t = __fmul_rn(sgn, fmaxf(__fsub_rn(fabsf(G), l1), 0.f));
  return __fdiv_rn(__fmul_rn(t, t), __fadd_rn(H, l2));
}

struct FinishArgs {
  const int32_t* acc;  // (C, N, F, B) lane sums
  int N, F, B, mode, cbits, hbits;
  // subtract mode: the parent histograms, int32 or int16, read at row
  // *parent_slot (the leaf-wise carry) or at the parent's own index
  const void* parent;
  int parent_i16;
  const long long* parent_slot;
  const uint8_t* small_left;
  // output o goes to row *slot[o] (the leaf-wise carry) or to row o
  void* hist;  // (rows, F, B, 3), int32 or int16
  int hist_i16;
  const long long* slot[2];
  // the gain scan (scales null: histograms only)
  const float* scales;
  const uint8_t* fmask;
  const uint8_t* edge;
  const uint8_t* dok;
  float l1, l2, min_data, min_hess;
  float* gain;     // each below indexed by the output's row, each nullable
  int32_t* feat;
  int32_t* bin;
  float* left;     // (rows, 3)
  float* tot;      // (rows, 3)
  float* scratch;  // (N, groups, outputs, kPart) partial bests
  unsigned* counter;  // (N,) zero at launch; each launch leaves them zero
  int Fb;             // features per block
};

__device__ __forceinline__ int load_cell(const void* base, int i16,
                                         long long idx) {
  return i16 ? (int)reinterpret_cast<const int16_t*>(base)[idx]
             : reinterpret_cast<const int32_t*>(base)[idx];
}

__device__ __forceinline__ void store_cell(void* base, int i16,
                                           long long idx, int v) {
  if (i16)  // narrowed as torch's .to(int16) wraps
    reinterpret_cast<int16_t*>(base)[idx] = (int16_t)v;
  else
    reinterpret_cast<int32_t*>(base)[idx] = v;
}

// rows of one shared plane: (outputs x 3 channels x Fb features)
__host__ __device__ __forceinline__ int n_rows(const FinishArgs& a) {
  return (a.parent != nullptr ? 2 : 1) * 3 * a.Fb;
}

// One block per (parent or direct node, group of Fb features); in subtract
// mode the block emits both children of its parent, so the parent's cells
// are read and the children's written by the same thread even when the
// left child's row is the parent's own (the leaf-wise carry).
__global__ void __launch_bounds__(kFinishThreads, 3)
    frontier_finish_kernel(const FinishArgs a) {
  // two [outputs * 3][Fb][SB] planes: the integer sums, and their f32
  // values, which the scan turns into prefix sums in place
  extern __shared__ __align__(16) int s_int[];
  __shared__ float s_par[2][kFinishMaxFeat][4];  // G H C score(parent)
  __shared__ float s_rg[2][kFinishThreads / 32];
  __shared__ int s_ri[2][kFinishThreads / 32];
  __shared__ int s_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.y, grp = blockIdx.x;
  // SB: a row of 16-byte chunks, an odd number of them, so the scan
  // lanes' 16-byte accesses fall on distinct banks
  const int F = a.F, B = a.B, SB = ((B + 3) & ~3) | 4;
  const int Bp = (B + 31) & ~31;
  float* s_cum = reinterpret_cast<float*>(s_int + n_rows(a) * SB);
  const int f0 = grp * a.Fb, fc = min(a.Fb, F - f0);
  const bool sub = a.parent != nullptr, gains = a.scales != nullptr;
  const int n_loc = sub ? 2 : 1;
  long long out_row[2];
#pragma unroll
  for (int o = 0; o < 2; ++o)
    out_row[o] = o < n_loc && a.slot[o] ? *a.slot[o]
                                        : (long long)row * n_loc + o;
  // two outputs on one row (both gated to the trash slot): the second
  // wins, as two writes in output order would leave it
  const bool write0 = n_loc == 1 || out_row[0] != out_row[1];
  const bool small_first = !sub || a.small_left[row] != 0;
  const long long prow = a.parent_slot ? *a.parent_slot : row;
  const float gsc = gains ? a.scales[0] : 0.f;
  const float hsc = gains ? a.scales[1] : 0.f;

  // every global load of this thread's cells (at most kFinishMaxFeat
  // rounds of the block) is issued before any store: the loads overlap,
  // and a parent cell is read before the same thread overwrites it
  const long long plane = (long long)a.N * F * B;
  const int cells = fc * Bp;  // bins B..Bp-1 of a feature: zeros
  int raw[kFinishMaxFeat][3], par[kFinishMaxFeat][3];
#pragma unroll
  for (int k = 0; k < kFinishMaxFeat; ++k) {
    const int i = tid + k * kFinishThreads;
    const int fl = i / Bp, b = i - fl * Bp;
    if (i < cells && b < B) {
      const long long cell = ((long long)row * F + f0 + fl) * B + b;
      load_lanes(a.acc, plane, cell, a.mode, raw[k]);
      if (sub) {
        const long long pc = ((prow * F + f0 + fl) * B + b) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          par[k][c] = load_cell(a.parent, a.parent_i16, pc + c);
      }
    }
  }
  // the gates of the cells this thread scores later, loaded now
  // (kept as loaded until the gains: a branch on them would wait here)
  uint8_t gate_f[kFinishMaxFeat], gate_e[kFinishMaxFeat];
#pragma unroll
  for (int k = 0; k < kFinishMaxFeat; ++k) {
    const int i = tid + k * kFinishThreads;
    const int fl = i / B, f = f0 + fl;
    gate_f[k] = gate_e[k] = 0;
    if (gains && i < fc * B) {
      gate_f[k] = a.fmask[f];
      gate_e[k] = a.edge[(long long)f * B + i - fl * B];
    }
  }

  // decode, subtract, store
#pragma unroll
  for (int k = 0; k < kFinishMaxFeat; ++k) {
    const int i = tid + k * kFinishThreads;
    if (i >= cells) break;  // uniform over each warp
    const int fl = i / Bp, b = i - fl * Bp, f = f0 + fl;
    int q[2][3] = {{0, 0, 0}, {0, 0, 0}};  // the outputs, in order
    if (b < B) {
      int s[3], d[3] = {0, 0, 0};  // the rebuilt child, its sibling
      unpack(raw[k], a.mode, a.cbits, a.hbits, s);
      if (sub) {  // sibling = parent - small, exact in int32
#pragma unroll
        for (int c = 0; c < 3; ++c) d[c] = par[k][c] - s[c];
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        q[0][c] = small_first ? s[c] : d[c];
        q[1][c] = small_first ? d[c] : s[c];
      }
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (o >= n_loc || (o == 0 && !write0)) continue;
        const long long oc = ((out_row[o] * F + f) * B + b) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          store_cell(a.hist, a.hist_i16, oc + c, q[o][c]);
      }
    }
    if (gains && b < SB) {  // the integer sums and their f32 values
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        if (o >= n_loc) continue;
        const int at = (o * 3 * a.Fb + fl) * SB + b, step = a.Fb * SB;
        s_int[at] = q[o][0];
        s_int[at + step] = q[o][1];
        s_int[at + 2 * step] = q[o][2];
        s_cum[at] = __fmul_rn(__int2float_rn(q[o][0]), gsc);
        s_cum[at + step] = __fmul_rn(__int2float_rn(q[o][1]), hsc);
        s_cum[at + 2 * step] = __int2float_rn(q[o][2]);
      }
    }
  }
  if (!gains) return;
  __syncthreads();

  // the f32 scan: warp 0, one lane per (output, channel, feature) chain,
  // bin 0 upwards, in place, 32 bins at a time through registers (16-byte
  // loads and stores); adding from -0 leaves bin 0 as it is (x + -0 == x
  // for every x).  Meanwhile warp 1 sums the same chains' integers: the
  // node totals, exact in any order.
  const int chains = n_loc * 3 * fc;
  const int oc = lane / fc, fl_c = lane % fc;
  if (warp == 0 && lane < chains) {
    float4* p = reinterpret_cast<float4*>(s_cum + (oc * a.Fb + fl_c) * SB);
    const int n4 = (B + 3) / 4;
    float run = -0.0f;
    for (int k0 = 0; k0 < n4; k0 += 8) {
      float4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < n4) v[u] = p[k0 + u];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        v[u].x = run = __fadd_rn(run, v[u].x);
        v[u].y = run = __fadd_rn(run, v[u].y);
        v[u].z = run = __fadd_rn(run, v[u].z);
        v[u].w = run = __fadd_rn(run, v[u].w);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < n4) p[k0 + u] = v[u];
    }
  } else if (warp == 1) {
    int itot = 0;
    if (lane < chains) {
      const int4* p =
          reinterpret_cast<const int4*>(s_int + (oc * a.Fb + fl_c) * SB);
      for (int k = 0; k < (B + 3) / 4; ++k) {
        const int4 v = p[k];
        itot += v.x + v.y + v.z + v.w;
      }
    }
    // the G lane of each (output, feature) takes H and C from its peers
    const int th_i = __shfl_sync(0xffffffffu, itot, min(lane + fc, 31));
    const int tc_i = __shfl_sync(0xffffffffu, itot, min(lane + 2 * fc, 31));
    if (lane < chains && oc % 3 == 0) {
      const int o = oc / 3;
      const float tg = __fmul_rn(__int2float_rn(itot), gsc);
      const float th = __fmul_rn(__int2float_rn(th_i), hsc);
      s_par[o][fl_c][0] = tg;
      s_par[o][fl_c][1] = th;
      s_par[o][fl_c][2] = __int2float_rn(tc_i);
      s_par[o][fl_c][3] = leaf_score(tg, th, a.l1, a.l2);
    }
  }
  __syncthreads();

  // score every (feature, bin) of the group, first max per output
  const bool depth_ok = a.dok == nullptr || a.dok[0] != 0;
  float best[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {0x7fffffff, 0x7fffffff};
#pragma unroll
  for (int k = 0; k < kFinishMaxFeat; ++k) {
    const int i = tid + k * kFinishThreads;
    if (i >= fc * B) break;
    const int fl = i / B, b = i - fl * B, f = f0 + fl;
    const bool ok_fb = depth_ok && gate_f[k] != 0 && gate_e[k] != 0;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      if (o >= n_loc) continue;
      const float* s = s_cum + (o * 3 * a.Fb + fl) * SB + b;
      const float GL = s[0], HL = s[a.Fb * SB], CL = s[2 * a.Fb * SB];
      const float* P = s_par[o][fl];
      const float GR = __fsub_rn(P[0], GL), HR = __fsub_rn(P[1], HL);
      const float CR = __fsub_rn(P[2], CL);
      float gain = __fsub_rn(__fadd_rn(leaf_score(GL, HL, a.l1, a.l2),
                                       leaf_score(GR, HR, a.l1, a.l2)),
                             P[3]);
      const bool ok = ok_fb && CL >= a.min_data && CR >= a.min_data &&
                      HL >= a.min_hess && HR >= a.min_hess;
      if (!ok) gain = -INFINITY;
      if (better(gain, f * B + b, best[o], best_i[o])) {
        best[o] = gain;
        best_i[o] = f * B + b;
      }
    }
  }
  const int G = gridDim.x;
  // first max over the block, both outputs at once: within each warp, then
  // over the eight warps in lanes 8o..8o+7 of warp 0
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    for (int off = 16; off > 0; off >>= 1) {
      const float og = __shfl_xor_sync(0xffffffffu, best[o], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[o], off);
      if (better(og, oi, best[o], best_i[o])) {
        best[o] = og;
        best_i[o] = oi;
      }
    }
    if (lane == 0) {
      s_rg[o][warp] = best[o];
      s_ri[o][warp] = best_i[o];
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int o = lane / 8, w = lane % 8;  // lanes 16..31 idle along
    float g = lane < 16 ? s_rg[o & 1][w] : -INFINITY;
    int gi = lane < 16 ? s_ri[o & 1][w] : 0x7fffffff;
    for (int off = 4; off > 0; off >>= 1) {
      const float og = __shfl_xor_sync(0xffffffffu, g, off);
      const int oi = __shfl_xor_sync(0xffffffffu, gi, off);
      if (better(og, oi, g, gi)) {
        g = og;
        gi = oi;
      }
    }
    if (w == 0 && o < n_loc) {
      // this block's partial best: gain, flat index, left sums, totals
      const int fl = gi / B - f0, b = gi % B;
      const float* s = s_cum + (o * 3 * a.Fb + fl) * SB + b;
      float4* r = reinterpret_cast<float4*>(
          a.scratch + (((long long)row * G + grp) * n_loc + o) * kPart);
      r[0] = make_float4(g, __int_as_float(gi), s[0], s[a.Fb * SB]);
      r[1] = make_float4(s[2 * a.Fb * SB], s_par[o][fl][0], s_par[o][fl][1],
                         s_par[o][fl][2]);
      __threadfence();  // the record reaches L2 before the count below
    }
    __syncwarp();
    // the last block of the row to finish reduces over the feature groups
    if (lane == 0) {
      const bool last =
          atomicAdd(&a.counter[row], 1u) == (unsigned)(G - 1);
      // acquire: the other groups' records, fenced before their counts,
      // are visible to this block after this fence and the barrier below
      if (last) __threadfence();
      s_last = last;
    }
  }
  __syncthreads();
  if (!s_last) return;
  // 256 / outputs threads per output, at most two groups each at the
  // bench's widths, all loaded at once; each thread keeps the record of its
  // best group, so no load follows the pick
  const int per = kFinishThreads / n_loc;
  const int o = tid / per, t_o = tid % per;
  const float4* recs = reinterpret_cast<const float4*>(
      a.scratch + (long long)row * G * n_loc * kPart);
  float g = -INFINITY;
  int gi = 0x7fffffff;
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
#pragma unroll 2
  for (int k = t_o; k < G; k += per) {
    const float4 rl = __ldcg(recs + (k * n_loc + o) * 2);
    const float4 rh = __ldcg(recs + (k * n_loc + o) * 2 + 1);
    if (better(rl.x, __float_as_int(rl.y), g, gi)) {
      g = rl.x;
      gi = __float_as_int(rl.y);
      lo = rl;
      hi = rh;
    }
  }
  float bg = g;
  int bi = gi;
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, bg, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (better(og, oi, bg, bi)) {
      bg = og;
      bi = oi;
    }
  }
  if (lane == 0) {
    s_rg[0][warp] = bg;
    s_ri[0][warp] = bi;
  }
  __syncthreads();
  const int wpo = per / 32;  // warps per output
  for (int w = o * wpo; w < (o + 1) * wpo; ++w) {
    if (better(s_rg[0][w], s_ri[0][w], bg, bi)) {
      bg = s_rg[0][w];
      bi = s_ri[0][w];
    }
  }
  // the flat index is unique, so exactly one thread holds the winner
  if (gi == bi && (o == 1 || write0)) {
    const long long at = o == 0 ? out_row[0] : out_row[1];
    const int feat = bi / B, bin = bi % B;
    const float v[6] = {lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    if (a.gain != nullptr) a.gain[at] = bg;
    if (a.feat != nullptr) a.feat[at] = feat;
    if (a.bin != nullptr) a.bin[at] = bin;
    if (a.left != nullptr)
      for (int k = 0; k < 3; ++k) a.left[at * 3 + k] = v[k];
    if (a.tot != nullptr)
      for (int k = 0; k < 3; ++k) a.tot[at * 3 + k] = v[3 + k];
  }
  if (tid == 0) a.counter[row] = 0;  // ready for the next launch
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int hist_accumulate_launch(const void* binned, long long s_row,
                           long long s_feat, const void* qg, const void* qh,
                           const void* node_ids, void* out, int n, int F,
                           int B, int N, int G, int NG, int Fg, int Ng,
                           int blocks, int mode, int cbits, int hbits,
                           void* stream) {
  const AccArgs a{(const uint8_t*)binned, s_row, s_feat, (const int8_t*)qg,
                  (const int8_t*)qh, (const int32_t*)node_ids, (int32_t*)out,
                  n, F, B, N, G, NG, Fg, Ng, mode, cbits, hbits};
  const size_t smem = (size_t)kAccWarps * kQueue * 8 +
                      (size_t)3 * Ng * Fg * B * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      hist_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  hist_accumulate_kernel<<<blocks, kAccThreads, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Null pointers switch parts off: parent/small_left (direct mode),
// parent_slot (a dense parent), slot0/slot1 (dense output rows), scales
// and everything after it up to counter (histograms only), dok (no depth
// gate), gain/feat/bin/left/tot (each output array).  The counters must be
// zero when a launch starts; the launch leaves them zero.
int frontier_finish_launch(
    const void* acc, int N, int F, int B, int mode, int cbits, int hbits,
    const void* parent, int parent_i16, const void* parent_slot,
    const void* small_left, void* hist, int hist_i16, const void* slot0,
    const void* slot1, const void* scales, const void* fmask,
    const void* edge, const void* dok, float l1, float l2, float min_data,
    float min_hess, void* gain, void* feat, void* bin, void* left,
    void* tot, void* scratch, void* counter, int Fb, void* stream) {
  if (B < 2 || B > kMaxBins || Fb < 1 || Fb > kFinishMaxFeat)
    return (int)cudaErrorInvalidValue;
  const FinishArgs a{
      (const int32_t*)acc, N, F, B, mode, cbits, hbits, parent, parent_i16,
      (const long long*)parent_slot, (const uint8_t*)small_left, hist,
      hist_i16, {(const long long*)slot0, (const long long*)slot1},
      (const float*)scales, (const uint8_t*)fmask, (const uint8_t*)edge,
      (const uint8_t*)dok, l1, l2, min_data, min_hess, (float*)gain,
      (int32_t*)feat, (int32_t*)bin, (float*)left, (float*)tot,
      (float*)scratch, (unsigned*)counter, Fb};
  const int SB = ((B + 3) & ~3) | 4;
  const size_t smem =
      scales != nullptr ? (size_t)2 * n_rows(a) * SB * sizeof(int) : 0;
  if (smem > 48 * 1024) {  // above 48 KB only after the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        frontier_finish_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((F + Fb - 1) / Fb, N);
  frontier_finish_kernel<<<grid, kFinishThreads, smem,
                           (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* frontier_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
