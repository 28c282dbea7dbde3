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
//   One warp per (output node, feature): decode the lane sums (floor div/mod
//   done as arithmetic shifts and masks: the lane terms are multiples of
//   2^cbits / 2^hbits, and all3 sums are negative whenever sum(qg) < 0),
//   optionally subtract the small child from its parent in int32, write the
//   int32 histogram, and (with gains) dequantize, scan the bins sequentially
//   in f32, score every bin with l1/l2 and the gates, and keep the first
//   maximum.  A second kernel reduces over features per node, lowest feature
//   first, which equals the flat first-max order of the TPU kernel.  Every
//   float operation uses an explicit round-to-nearest intrinsic, so no
//   multiply-add is contracted and the result equals the plain PyTorch
//   version (ops/cuda_histogram.py::frontier_finish_plain) bit for bit.
//   Bound: bytes (lane sums, parent and output histograms).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kAccThreads = 1024;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kQueue = 64;     // per-warp queue of active rows (two batches)
constexpr int kRowChunks = 4;  // 32-row chunks whose loads a warp overlaps
constexpr int kFeatBatch = 8;  // bin loads in flight before their atomics
constexpr int kFinishWarps = 4;
constexpr int kMaxBins = 256;
constexpr int kRecord = 8;  // per (node, feature): gain bin GL HL CL G H C

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

// (qg_sum, qh_sum, count) of one cell from its packed lane sums
__device__ __forceinline__ void decode(const int32_t* __restrict__ acc,
                                       long long plane, long long idx,
                                       int mode, int cbits, int hbits,
                                       int& q0, int& q1, int& q2) {
  if (mode == 0) {  // all3: ((qg * KH) + qh) * KC + count
    const int32_t s = acc[idx];
    q2 = s & ((1 << cbits) - 1);
    const int32_t s2 = s >> cbits;
    q1 = s2 & ((1 << hbits) - 1);
    q0 = s2 >> hbits;
  } else if (mode == 1) {  // 2ch: qg | qh * KC + count
    q0 = acc[idx];
    const int32_t s = acc[plane + idx];
    q2 = s & ((1 << cbits) - 1);
    q1 = s >> cbits;
  } else {  // wide
    q0 = acc[idx];
    q1 = acc[plane + idx];
    q2 = acc[2 * plane + idx];
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

__global__ void frontier_finish_kernel(
    const int32_t* __restrict__ acc, int N, int F, int B, int mode,
    int cbits, int hbits, const int32_t* __restrict__ parent,
    const uint8_t* __restrict__ small_left, int32_t* __restrict__ hist,
    const float* __restrict__ scales, const uint8_t* __restrict__ fmask,
    const uint8_t* __restrict__ edge, const uint8_t* __restrict__ dok,
    float l1, float l2, float min_data, float min_hess,
    float* __restrict__ record) {
  __shared__ float sG[kFinishWarps][kMaxBins];
  __shared__ float sH[kFinishWarps][kMaxBins];
  __shared__ float sC[kFinishWarps][kMaxBins];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int o = blockIdx.y;
  const int f = blockIdx.x * kFinishWarps + warp;
  if (f >= F) return;  // whole warps leave; no block barrier follows

  int k = o;          // source node of the lane sums
  bool small = true;  // this output is the rebuilt (smaller) child
  if (parent != nullptr) {
    k = o >> 1;
    small = ((o & 1) == 0) == (small_left[k] != 0);
  }
  const bool gains = record != nullptr;
  const float gsc = gains ? scales[0] : 0.f;
  const float hsc = gains ? scales[1] : 0.f;
  const long long plane = (long long)N * F * B;
  const long long src = ((long long)k * F + f) * B;
  int32_t* out = hist + ((long long)o * F + f) * B * 3;
  int t0 = 0, t1 = 0, t2 = 0;
  for (int b = lane; b < B; b += 32) {
    int q0, q1, q2;
    decode(acc, plane, src + b, mode, cbits, hbits, q0, q1, q2);
    if (!small) {
      const int32_t* p = parent + (src + b) * 3;
      q0 = p[0] - q0;
      q1 = p[1] - q1;
      q2 = p[2] - q2;
    }
    out[b * 3 + 0] = q0;
    out[b * 3 + 1] = q1;
    out[b * 3 + 2] = q2;
    if (gains) {
      sG[warp][b] = __fmul_rn(__int2float_rn(q0), gsc);
      sH[warp][b] = __fmul_rn(__int2float_rn(q1), hsc);
      sC[warp][b] = __int2float_rn(q2);
      t0 += q0;
      t1 += q1;
      t2 += q2;
    }
  }
  if (!gains) return;

  // node totals from the exact integer sums: every row of the node lands in
  // exactly one bin of every feature, so any feature gives the same sums
  for (int off = 16; off > 0; off >>= 1) {
    t0 += __shfl_xor_sync(0xffffffffu, t0, off);
    t1 += __shfl_xor_sync(0xffffffffu, t1, off);
    t2 += __shfl_xor_sync(0xffffffffu, t2, off);
  }
  __syncwarp();
  if (lane < 3) {  // one sequential f32 scan per channel, bin 0 upwards
    float* a = lane == 0 ? sG[warp] : (lane == 1 ? sH[warp] : sC[warp]);
    float run = a[0];
    for (int b = 1; b < B; ++b) {
      run = __fadd_rn(run, a[b]);
      a[b] = run;
    }
  }
  __syncwarp();

  const float tg = __fmul_rn(__int2float_rn(t0), gsc);
  const float th = __fmul_rn(__int2float_rn(t1), hsc);
  const float tc = __int2float_rn(t2);
  const float sP = leaf_score(tg, th, l1, l2);
  const bool feat_ok = fmask[f] != 0 && (dok == nullptr || dok[0] != 0);
  float best = -INFINITY;
  int best_b = 0x7fffffff;
  for (int b = lane; b < B; b += 32) {
    const float GL = sG[warp][b], HL = sH[warp][b], CL = sC[warp][b];
    const float GR = __fsub_rn(tg, GL), HR = __fsub_rn(th, HL);
    const float CR = __fsub_rn(tc, CL);
    float gain = __fsub_rn(__fadd_rn(leaf_score(GL, HL, l1, l2),
                                     leaf_score(GR, HR, l1, l2)), sP);
    const bool ok = feat_ok && edge[(long long)f * B + b] != 0 &&
                    CL >= min_data && CR >= min_data && HL >= min_hess &&
                    HR >= min_hess;
    if (!ok) gain = -INFINITY;
    if (better(gain, b, best, best_b)) {
      best = gain;
      best_b = b;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, best, off);
    const int ob = __shfl_xor_sync(0xffffffffu, best_b, off);
    if (better(og, ob, best, best_b)) {
      best = og;
      best_b = ob;
    }
  }
  if (lane == 0) {
    float* rec = record + ((long long)o * F + f) * kRecord;
    rec[0] = best;
    rec[1] = (float)best_b;
    rec[2] = sG[warp][best_b];
    rec[3] = sH[warp][best_b];
    rec[4] = sC[warp][best_b];
    rec[5] = tg;
    rec[6] = th;
    rec[7] = tc;
  }
}

// per node: first max over the per-feature records -> the 9-float record
// [gain, feature, bin, GL, HL, CL, G, H, C]
__global__ void frontier_best_kernel(const float* __restrict__ record, int F,
                                     float* __restrict__ best) {
  __shared__ float sg[32];
  __shared__ int sf[32];
  const int o = blockIdx.x;
  const float* rec = record + (long long)o * F * kRecord;
  float g = -INFINITY;
  int bf = 0x7fffffff;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    const float v = rec[(long long)f * kRecord];
    if (better(v, f, g, bf)) {
      g = v;
      bf = f;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_xor_sync(0xffffffffu, g, off);
    const int of = __shfl_xor_sync(0xffffffffu, bf, off);
    if (better(og, of, g, bf)) {
      g = og;
      bf = of;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sg[warp] = g;
    sf[warp] = bf;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int warps = (blockDim.x + 31) / 32;
    for (int w = 1; w < warps; ++w) {
      if (better(sg[w], sf[w], g, bf)) {
        g = sg[w];
        bf = sf[w];
      }
    }
    const float* r = rec + (long long)bf * kRecord;
    float* out = best + (long long)o * 9;
    out[0] = r[0];
    out[1] = (float)bf;
    out[2] = r[1];
    out[3] = r[2];
    out[4] = r[3];
    out[5] = r[4];
    out[6] = r[5];
    out[7] = r[6];
    out[8] = r[7];
  }
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

// parent/small_left are null in direct mode; scales/fmask/edge/record/best
// are null when only the histogram is wanted; dok is null without a gate.
int frontier_finish_launch(const void* acc, int N, int F, int B, int mode,
                           int cbits, int hbits, const void* parent,
                           const void* small_left, void* hist, int n_out,
                           const void* scales, const void* fmask,
                           const void* edge, const void* dok, float l1,
                           float l2, float min_data, float min_hess,
                           void* record, void* best, void* stream) {
  if (B > kMaxBins) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + kFinishWarps - 1) / kFinishWarps, n_out);
  frontier_finish_kernel<<<grid, kFinishWarps * 32, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)acc, N, F, B, mode, cbits, hbits,
      (const int32_t*)parent, (const uint8_t*)small_left, (int32_t*)hist,
      (const float*)scales, (const uint8_t*)fmask, (const uint8_t*)edge,
      (const uint8_t*)dok, l1, l2, min_data, min_hess, (float*)record);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || record == nullptr) return (int)err;
  frontier_best_kernel<<<n_out, 256, 0, (cudaStream_t)stream>>>(
      (const float*)record, F, (float*)best);
  return (int)cudaGetLastError();
}

const char* frontier_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
