// Quantize / dequantize the compressed wire's (R, tile) float32 layout.
//
// Replaces: src/repro/kernels/quant_transfer.py `_quantize_kernel` /
// `quantize_tiles` and `_dequantize_kernel` / `dequantize_tiles` (Pallas,
// TPU).  Per row (one scale tile): amax = max |x|, scale = amax / QDIV
// (QDIV = 128 for int8, 256 for fp8; 1.0 for an all-zero row),
// q = clip(round_half_even(x / scale), -127, 127) as int8, or x / scale cast
// to fp8 e4m3 (round to nearest even); dequantize is float(q) * scale.
//
// Bitwise contract: the results equal the plain versions
// (repro_torch/kernels/ref.py, and repro's ref.py) bit for bit.  So x / scale
// is a true IEEE division (__fdiv_rn; never a reciprocal multiply, and the
// build never uses --use_fast_math): amax / QDIV is exact because QDIV is a
// power of two, but 1 / scale is not.  int8 rounds with __float2int_rn
// (half to even, as jnp.round / torch.round), not roundf (half away from
// zero).  fp8 converts with __nv_cvt_float_to_fp8(.., __NV_SATFINITE,
// __NV_E4M3), round to nearest even; |x / scale| <= 256 < 448 so the
// saturation never applies.
//
// Bound on the card: bytes.  Quantize reads 4 bytes and writes 1 per
// element (+4 bytes of scale per row); at the slice's largest gradient leaf
// (3,145,728 x 256) that is 4.0 GB, >= 1.2 ms at 3.35 TB/s.  Dequantize
// reads 1 and writes 4.
//
// Design: one warp per row, eight rows per block, a grid-stride loop over
// rows.  The TPU kernel's grid of row blocks needs nothing carried across
// steps, so it maps directly.  When the tile is a multiple of 128 (up to
// 1024) and the row is 16-byte aligned, each lane holds its tile / 32
// elements in registers as float4 loads (the row is read from memory once),
// the abs-max is reduced with warp shuffles (max is order-independent, so
// the reduction is exact), and the payload is written as 4-byte words.
// Other tiles take a generic path that reads the row twice (the second read
// hits L1).
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace {

constexpr int kWarps = 8;

__device__ __forceinline__ unsigned char encode(float x, float s, int fmt) {
  const float y = __fdiv_rn(x, s);
  if (fmt == 0) {
    const int i = max(-127, min(127, __float2int_rn(y)));
    return static_cast<unsigned char>(static_cast<signed char>(i));
  }
  return static_cast<unsigned char>(__nv_cvt_float_to_fp8(y, __NV_SATFINITE, __NV_E4M3));
}

__device__ __forceinline__ float decode(unsigned char b, int fmt) {
  if (fmt == 0) return static_cast<float>(static_cast<signed char>(b));
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_scale(float amax, float qdiv) {
  return amax > 0.f ? __fdiv_rn(amax, qdiv) : 1.0f;
}

// NV float4 per lane: tile = 128 * NV.
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
quantize_vec(const float* __restrict__ x, unsigned char* __restrict__ q,
             float* __restrict__ scale, long long R, int fmt, float qdiv) {
  constexpr int kTile = 128 * NV;
  const int lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32; r < R; r += stride) {
    const float4* xr = reinterpret_cast<const float4*>(x + r * kTile);
    float4 v[NV];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      v[j] = xr[lane + 32 * j];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                               fmaxf(fabsf(v[j].z), fabsf(v[j].w))));
    }
    const float s = row_scale(warp_max(amax), qdiv);
    uchar4* qr = reinterpret_cast<uchar4*>(q + r * kTile);
#pragma unroll
    for (int j = 0; j < NV; ++j)
      qr[lane + 32 * j] = make_uchar4(encode(v[j].x, s, fmt), encode(v[j].y, s, fmt),
                                      encode(v[j].z, s, fmt), encode(v[j].w, s, fmt));
    if (lane == 0) scale[r] = s;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
quantize_any(const float* __restrict__ x, unsigned char* __restrict__ q,
             float* __restrict__ scale, long long R, int tile, int fmt, float qdiv) {
  const int lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32; r < R; r += stride) {
    const float* xr = x + r * tile;
    float amax = 0.f;
    for (int c = lane; c < tile; c += 32) amax = fmaxf(amax, fabsf(xr[c]));
    const float s = row_scale(warp_max(amax), qdiv);
    for (int c = lane; c < tile; c += 32) q[r * tile + c] = encode(xr[c], s, fmt);
    if (lane == 0) scale[r] = s;
  }
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
dequantize_vec(const unsigned char* __restrict__ q, const float* __restrict__ scale,
               float* __restrict__ out, long long R, int fmt) {
  constexpr int kTile = 128 * NV;
  const int lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32; r < R; r += stride) {
    const uchar4* qr = reinterpret_cast<const uchar4*>(q + r * kTile);
    float4* orow = reinterpret_cast<float4*>(out + r * kTile);
    const float s = scale[r];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const uchar4 b = qr[lane + 32 * j];
      orow[lane + 32 * j] = make_float4(decode(b.x, fmt) * s, decode(b.y, fmt) * s,
                                        decode(b.z, fmt) * s, decode(b.w, fmt) * s);
    }
  }
}

__global__ void __launch_bounds__(kWarps * 32)
dequantize_any(const unsigned char* __restrict__ q, const float* __restrict__ scale,
               float* __restrict__ out, long long R, int tile, int fmt) {
  const int lane = threadIdx.x % 32;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long r = (long long)blockIdx.x * kWarps + threadIdx.x / 32; r < R; r += stride) {
    const float s = scale[r];
    for (int c = lane; c < tile; c += 32) out[r * tile + c] = decode(q[r * tile + c], fmt) * s;
  }
}

unsigned grid_for(long long R) {
  const long long blocks = (R + kWarps - 1) / kWarps;
  return static_cast<unsigned>(blocks < (1 << 20) ? blocks : (1 << 20));
}

bool aligned16(const void* p) { return reinterpret_cast<unsigned long long>(p) % 16 == 0; }

}  // namespace

extern "C" {

// fmt: 0 = int8, 1 = fp8 e4m3.  x: (R, tile) float32 contiguous; q: (R, tile)
// bytes; scale: (R,) float32.  qdiv: the format's power-of-two divisor.
int quantize_tiles(int fmt, const void* x, void* q, void* scale, long long R,
                   int tile, float qdiv, void* stream) {
  if ((fmt != 0 && fmt != 1) || tile <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  unsigned char* qb = static_cast<unsigned char*>(q);
  float* sf = static_cast<float*>(scale);
  const unsigned grid = grid_for(R);
  const bool vec = tile % 128 == 0 && tile <= 1024 && aligned16(x) && aligned16(q);
  switch (vec ? tile / 128 : 0) {
    case 1: quantize_vec<1><<<grid, kWarps * 32, 0, st>>>(xf, qb, sf, R, fmt, qdiv); break;
    case 2: quantize_vec<2><<<grid, kWarps * 32, 0, st>>>(xf, qb, sf, R, fmt, qdiv); break;
    case 4: quantize_vec<4><<<grid, kWarps * 32, 0, st>>>(xf, qb, sf, R, fmt, qdiv); break;
    case 8: quantize_vec<8><<<grid, kWarps * 32, 0, st>>>(xf, qb, sf, R, fmt, qdiv); break;
    default: quantize_any<<<grid, kWarps * 32, 0, st>>>(xf, qb, sf, R, tile, fmt, qdiv);
  }
  return (int)cudaGetLastError();
}

// out: (R, tile) float32 = float(q) * scale[row].
int dequantize_tiles(int fmt, const void* q, const void* scale, void* out,
                     long long R, int tile, void* stream) {
  if ((fmt != 0 && fmt != 1) || tile <= 0 || R < 0) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* qb = static_cast<const unsigned char*>(q);
  const float* sf = static_cast<const float*>(scale);
  float* of = static_cast<float*>(out);
  const unsigned grid = grid_for(R);
  const bool vec = tile % 128 == 0 && tile <= 1024 && aligned16(q) && aligned16(out);
  switch (vec ? tile / 128 : 0) {
    case 1: dequantize_vec<1><<<grid, kWarps * 32, 0, st>>>(qb, sf, of, R, fmt); break;
    case 2: dequantize_vec<2><<<grid, kWarps * 32, 0, st>>>(qb, sf, of, R, fmt); break;
    case 4: dequantize_vec<4><<<grid, kWarps * 32, 0, st>>>(qb, sf, of, R, fmt); break;
    case 8: dequantize_vec<8><<<grid, kWarps * 32, 0, st>>>(qb, sf, of, R, fmt); break;
    default: dequantize_any<<<grid, kWarps * 32, 0, st>>>(qb, sf, of, R, tile, fmt);
  }
  return (int)cudaGetLastError();
}

const char* quant_transfer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
