// Fused GBDT frontier step for Hopper (sm_90a): the two halves of the TPU
// kernel in mmlspark_tpu/ops/pallas_histogram.py (_make_kernel, launched by
// _frontier's pl.pallas_call), written as two CUDA kernels.
//
// hist_accumulate (replaces _make_kernel:199-238, the accumulation half)
//   For every row with node >= 0, add its packed int32 lanes (C = 1..3,
//   ops.histogram._pack_lanes) into the (node, feature, bin) cell.  Grid:
//   (feature group, node group, row chunk).  Each block keeps a private
//   C x Ng x Fg x B int32 accumulator in shared memory, adds with shared
//   atomics, then merges non-zero cells into the zeroed (C, N, F, B) output
//   with global atomics.  Integer addition is associative (mod 2^32), so the
//   sums are bit-identical in any order.  Node groups span the grid, so any
//   frontier width is covered.  Bound: bytes — every row's bins are read once
//   per frontier step (n * F bytes, 200 MB at 1M x 200).  The binned matrix
//   is read feature-major (s_row = 1), so a warp reads 32 consecutive rows of
//   one feature; feature groups are the fastest grid axis, so blocks that
//   share a row chunk run together and re-read lanes and node ids from L2.
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

constexpr int kAccThreads = 512;
constexpr int kFinishWarps = 4;
constexpr int kMaxBins = 256;
constexpr int kRecord = 8;  // per (node, feature): gain bin GL HL CL G H C

__global__ void hist_accumulate_kernel(
    const uint8_t* __restrict__ binned, long long s_row, long long s_feat,
    const int32_t* __restrict__ lanes, const int32_t* __restrict__ node_ids,
    int32_t* __restrict__ acc, int n, int F, int B, int N, int C, int Fg,
    int Ng, int row_chunk) {
  extern __shared__ int32_t sh[];  // (C, Ng, Fg, B)
  const int f0 = blockIdx.x * Fg;
  const int g0 = blockIdx.y * Ng;
  const int fcount = min(Fg, F - f0);
  const int gcount = min(Ng, N - g0);
  const int plane = Ng * Fg * B;
  const int cells = C * plane;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) sh[i] = 0;
  __syncthreads();

  const long long r_begin = (long long)blockIdx.z * row_chunk;
  const long long r_end = min((long long)n, r_begin + row_chunk);
  for (long long r = r_begin + threadIdx.x; r < r_end; r += blockDim.x) {
    const int g = node_ids[r] - g0;  // rows with node < 0 land below 0
    if (g < 0 || g >= gcount) continue;
    int32_t v[3];
    for (int c = 0; c < C; ++c) v[c] = lanes[(long long)c * n + r];
    const uint8_t* row = binned + r * s_row + (long long)f0 * s_feat;
    int32_t* cell_g = sh + g * Fg * B;
    for (int f = 0; f < fcount; ++f) {
      const int b = row[(long long)f * s_feat];
      if (b >= B) continue;  // out-of-contract bin: never write past a row
      int32_t* cell = cell_g + f * B + b;
      for (int c = 0; c < C; ++c) atomicAdd(cell + c * plane, v[c]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int32_t val = sh[i];
    if (val == 0) continue;
    const int b = i % B;
    int t = i / B;
    const int f = t % Fg;
    t /= Fg;
    const int g = t % Ng;
    const int c = t / Ng;
    atomicAdd(acc + (((long long)c * N + g0 + g) * F + f0 + f) * B + b, val);
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
                           long long s_feat, const void* lanes,
                           const void* node_ids, void* acc, int n, int F,
                           int B, int N, int C, int Fg, int Ng, int row_chunk,
                           int chunks, void* stream) {
  const size_t smem = (size_t)C * Ng * Fg * B * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      hist_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + Fg - 1) / Fg, (N + Ng - 1) / Ng, chunks);
  hist_accumulate_kernel<<<grid, kAccThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)binned, s_row, s_feat, (const int32_t*)lanes,
      (const int32_t*)node_ids, (int32_t*)acc, n, F, B, N, C, Fg, Ng,
      row_chunk);
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
