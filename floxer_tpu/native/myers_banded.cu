// Banded sliding-window Myers edit distance for NVIDIA Hopper (sm_90a),
// called from JAX through the XLA FFI (ops/banded_cuda.py).
//
// Contract: identical (distance, end column) to ops/banded._banded_xla for
// every task; the algorithm and its exactness proof are in
// ops/myers_banded.py, the band layout in ops/banded.py.
//
// One warp per task. The band's BW = 32 * WPL words of each state array
// (VP, VN, three char bit-planes, the all-match plane) are spread over the
// 32 lanes, WPL consecutive words per lane, and stay in registers for the
// whole column loop:
//   - the carry of (Eq & VP) + VP ripples inside each lane; the lanes then
//     exchange one generate and one propagate bit with __ballot_sync, and
//     one 32-bit add resolves every lane's carry-in at once;
//   - the one-bit shifts between words cross lanes with __shfl_*_sync;
//   - text and stream chars arrive as 4-bit nibbles, one 32-bit word per
//     8 columns;
//   - each task stops at its own text length.
//
// Inputs (row-major, one row per task):
//   vp0      uint32 [T, BW]      initial VP band
//   planes0  uint32 [T, 4, BW]   char bit-planes 0..2 + all-match plane
//   texts    uint32 [T, NW]      text chars, 8 nibbles per word
//   stream   uint32 [T, NW]      entering pattern-row chars, same packing
//   scalars  int32  [T, 6]       tlen, j_star, top_shift, m_frozen, m, budget
// Outputs: dist int32 [T, 1], end int32 [T, 1].

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr uint32_t kTopBit = 0x80000000u;
constexpr int kWarpsPerBlock = 4;
constexpr int kNumScalars = 6;

// Band one bit toward lower rows: each word takes the next word's bit 0 as
// its top bit; the lane's last word takes it from the next lane (`from_next`
// bit `bit`), and the band's last word takes the entering row instead.
template <int WPL>
__device__ __forceinline__ void slide(uint32_t (&x)[WPL], uint32_t from_next,
                                      int bit, uint32_t entering) {
#pragma unroll
  for (int i = 0; i < WPL - 1; ++i) x[i] = (x[i] >> 1) | (x[i + 1] << 31);
  x[WPL - 1] = (x[WPL - 1] >> 1) | (((from_next >> bit) & 1u) << 31) |
               entering;
}

template <int WPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    banded_myers_kernel(const uint32_t* __restrict__ vp0,
                        const uint32_t* __restrict__ planes0,
                        const uint32_t* __restrict__ texts,
                        const uint32_t* __restrict__ stream,
                        const int32_t* __restrict__ scalars,
                        int32_t* __restrict__ dist_out,
                        int32_t* __restrict__ end_out, int num_tasks,
                        int text_words) {
  constexpr int BW = 32 * WPL;
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (task >= num_tasks) return;  // the whole warp leaves together

  const int32_t* sc = scalars + static_cast<size_t>(task) * kNumScalars;
  const int tlen = sc[0];
  const int jstar = sc[1];
  const int top_shift = sc[2];
  const int m_frozen = sc[3];
  const int m = sc[4];
  const int budget = sc[5];

  uint32_t vp[WPL], vn[WPL], p0[WPL], p1[WPL], p2[WPL], am[WPL];
  const uint32_t* vp_src = vp0 + static_cast<size_t>(task) * BW + lane * WPL;
  const uint32_t* pl_src =
      planes0 + static_cast<size_t>(task) * 4 * BW + lane * WPL;
#pragma unroll
  for (int i = 0; i < WPL; ++i) {
    vp[i] = vp_src[i];
    vn[i] = 0u;
    p0[i] = pl_src[i];
    p1[i] = pl_src[BW + i];
    p2[i] = pl_src[2 * BW + i];
    am[i] = pl_src[3 * BW + i];
  }
  const bool first_lane = lane == 0;
  const bool last_lane = lane == 31;

  // the scores are those of the band's last word, which lane 31 holds;
  // the other lanes carry the same arithmetic on values nobody reads
  int s_bot = budget;
  int s_m = m;
  int best = m;
  int best_end = 0;

  // column col = 8 * b + s + 1; only col < tlen can score
  int blocks = tlen > 1 ? (tlen + 6) / 8 : 0;
  if (blocks > text_words) blocks = text_words;
  const uint32_t* text_row = texts + static_cast<size_t>(task) * text_words;
  const uint32_t* stream_row = stream + static_cast<size_t>(task) * text_words;

  for (int b = 0; b < blocks; ++b) {
    const uint32_t text_word = text_row[b];
    const uint32_t stream_word = stream_row[b];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int col = 8 * b + s + 1;
      const uint32_t tch = (text_word >> (4 * s)) & 0xFu;
      const uint32_t pch = (stream_word >> (4 * s)) & 0xFu;
      const bool sliding = col <= jstar;  // the same in every lane

      if (sliding) {
        const uint32_t pack = (vp[0] & 1u) | ((vn[0] & 1u) << 1) |
                              ((p0[0] & 1u) << 2) | ((p1[0] & 1u) << 3) |
                              ((p2[0] & 1u) << 4) | ((am[0] & 1u) << 5);
        uint32_t from_next = __shfl_down_sync(kFullMask, pack, 1);
        if (last_lane) from_next = 0u;
        // the entering bottom row: pessimistic VP, its pattern char's planes
        const uint32_t top = last_lane ? kTopBit : 0u;
        slide(vp, from_next, 0, top);
        slide(vn, from_next, 1, 0u);
        slide(p0, from_next, 2, (pch & 1u) ? top : 0u);
        slide(p1, from_next, 3, (pch & 2u) ? top : 0u);
        slide(p2, from_next, 4, (pch & 4u) ? top : 0u);
        slide(am, from_next, 5, 0u);
        ++s_bot;
      }

      // Eq from the char bit-planes: XNOR each plane with the text char's bit
      const uint32_t f0 = (tch & 1u) ? 0u : kFullMask;
      const uint32_t f1 = (tch & 2u) ? 0u : kFullMask;
      const uint32_t f2 = (tch & 4u) ? 0u : kFullMask;
      uint32_t eq[WPL], sum[WPL];
      uint32_t lane_generate = 0u;
      uint32_t lane_propagate = 1u;
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        eq[i] = ((p0[i] ^ f0) & (p1[i] ^ f1) & (p2[i] ^ f2)) | am[i];
        const uint32_t a = eq[i] & vp[i];
        sum[i] = a + vp[i];
        const uint32_t generate = sum[i] < a ? 1u : 0u;
        const uint32_t propagate = sum[i] == kFullMask ? 1u : 0u;
        lane_generate = generate | (propagate & lane_generate);
        lane_propagate &= propagate;
      }
      // carry into each lane: the carries of g + (g | p) over the 32 lanes
      // as the bits of one word (g and p are disjoint per lane)
      const uint32_t g = __ballot_sync(kFullMask, lane_generate);
      const uint32_t gp = g | __ballot_sync(kFullMask, lane_propagate);
      uint32_t carry = (((gp + g) ^ gp ^ g) >> lane) & 1u;

      uint32_t ph[WPL], mh[WPL], xv[WPL];
#pragma unroll
      for (int i = 0; i < WPL; ++i) {
        const uint32_t generate = sum[i] < (eq[i] & vp[i]) ? 1u : 0u;
        const uint32_t propagate = sum[i] == kFullMask ? 1u : 0u;
        const uint32_t total = sum[i] + carry;
        carry = generate | (propagate & carry);
        const uint32_t xh = (total ^ vp[i]) | eq[i];
        xv[i] = eq[i] | vn[i];
        ph[i] = vn[i] | ~(xh | vp[i]);
        mh[i] = vp[i] & xh;
      }

      // score deltas at the static band-bottom bit
      const int d_bot = static_cast<int>(ph[WPL - 1] >> 31) -
                        static_cast<int>(mh[WPL - 1] >> 31);
      s_bot += d_bot;
      s_m = col == jstar ? s_bot : s_m + (sliding ? 0 : d_bot);

      // horizontal deltas one row down; lane 0's first word takes the
      // entering top delta: +1 (pessimistic) once the top stored row is real
      const bool pessimistic = sliding ? col >= top_shift : m_frozen != 0;
      const uint32_t h_pack = (ph[WPL - 1] >> 31) | ((mh[WPL - 1] >> 31) << 1);
      uint32_t from_prev = __shfl_up_sync(kFullMask, h_pack, 1);
      if (first_lane) from_prev = pessimistic ? 1u : 0u;
#pragma unroll
      for (int i = WPL - 1; i >= 0; --i) {
        const uint32_t ph_in = i > 0 ? ph[i - 1] >> 31 : from_prev & 1u;
        const uint32_t mh_in = i > 0 ? mh[i - 1] >> 31 : (from_prev >> 1) & 1u;
        const uint32_t ph_shifted = (ph[i] << 1) | ph_in;
        const uint32_t mh_shifted = (mh[i] << 1) | mh_in;
        vp[i] = mh_shifted | ~(xv[i] | ph_shifted);
        vn[i] = ph_shifted & xv[i];
      }

      if (col < tlen && col >= jstar && s_m <= best) {
        best = s_m;
        best_end = col;
      }
    }
  }
  if (last_lane) {
    dist_out[task] = best;
    end_out[task] = best_end;
  }
}

template <int WPL>
ffi::Error launch(cudaStream_t cuda_stream, const uint32_t* vp0,
                  const uint32_t* planes0, const uint32_t* texts,
                  const uint32_t* stream, const int32_t* scalars,
                  int32_t* dist, int32_t* end, int num_tasks,
                  int text_words) {
  const int blocks = (num_tasks + kWarpsPerBlock - 1) / kWarpsPerBlock;
  banded_myers_kernel<WPL><<<blocks, kWarpsPerBlock * 32, 0, cuda_stream>>>(vp0, planes0, texts, stream, scalars, dist, end, num_tasks, text_words);
  const cudaError_t error = cudaGetLastError();
  if (error != cudaSuccess) {
    return ffi::Error::Internal(cudaGetErrorString(error));
  }
  return ffi::Error::Success();
}

ffi::Error BandedMyersImpl(cudaStream_t cuda_stream,
                           ffi::Buffer<ffi::U32> vp0,
                           ffi::Buffer<ffi::U32> planes0,
                           ffi::Buffer<ffi::U32> texts,
                           ffi::Buffer<ffi::U32> stream,
                           ffi::Buffer<ffi::S32> scalars,
                           ffi::ResultBuffer<ffi::S32> dist,
                           ffi::ResultBuffer<ffi::S32> end) {
  const auto vp_dims = vp0.dimensions();
  const auto plane_dims = planes0.dimensions();
  const auto text_dims = texts.dimensions();
  const auto stream_dims = stream.dimensions();
  const auto scalar_dims = scalars.dimensions();
  if (vp_dims.size() != 2 || plane_dims.size() != 3 ||
      text_dims.size() != 2 || stream_dims.size() != 2 ||
      scalar_dims.size() != 2) {
    return ffi::Error::InvalidArgument("floxer_myers_banded: bad ranks");
  }
  const int64_t num_tasks = vp_dims[0];
  const int64_t band_words = vp_dims[1];
  const int64_t text_words = text_dims[1];
  if (plane_dims[0] != num_tasks || plane_dims[1] != 4 ||
      plane_dims[2] != band_words || text_dims[0] != num_tasks ||
      stream_dims[0] != num_tasks || stream_dims[1] != text_words ||
      scalar_dims[0] != num_tasks || scalar_dims[1] != kNumScalars ||
      dist->element_count() != static_cast<size_t>(num_tasks) ||
      end->element_count() != static_cast<size_t>(num_tasks)) {
    return ffi::Error::InvalidArgument("floxer_myers_banded: bad shapes");
  }
  if (num_tasks == 0) return ffi::Error::Success();
  const int tasks = static_cast<int>(num_tasks);
  const int words = static_cast<int>(text_words);
#define FLOXER_LAUNCH(WPL)                                                  \
  case 32 * WPL:                                                            \
    return launch<WPL>(cuda_stream, vp0.typed_data(), planes0.typed_data(), \
                       texts.typed_data(), stream.typed_data(),             \
                       scalars.typed_data(), dist->typed_data(),            \
                       end->typed_data(), tasks, words);
  switch (band_words) {
    FLOXER_LAUNCH(4)
    FLOXER_LAUNCH(8)
    FLOXER_LAUNCH(12)
    FLOXER_LAUNCH(16)
    FLOXER_LAUNCH(20)
    FLOXER_LAUNCH(24)
    FLOXER_LAUNCH(28)
    FLOXER_LAUNCH(32)
    default:
      return ffi::Error::InvalidArgument(
          "floxer_myers_banded: band_words must be a multiple of 128 up to "
          "1024");
  }
#undef FLOXER_LAUNCH
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FloxerMyersBanded, BandedMyersImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::S32>>());
