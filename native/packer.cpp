// Host-side batch packer for the object-ingestion pipeline.
//
// The reference's ingestion is a sequential Python loop (one imread + one
// DataFrame row per image, ipynb:358-364). In this framework the host-side
// hot loop that remains after moving compute to the device is assembling
// variable-size object crops into fixed-shape (B, H, W, C) device-feed
// buffers: center crop/pad, dtype widening, and 16-bit -> level quantisation.
// That is pure memory movement, so it lives here as a small C++ library with
// a thread pool, exposed to Python over ctypes (no pybind11 in this image).
//
// Exposed entry points (C ABI):
//   tpumcia_pack_u8 / tpumcia_pack_u16:
//     scatter N variable-size (h_i, w_i, c) sources into out[B, H, W, c]
//     with symmetric crop/pad, parallel across objects.
//   tpumcia_quantize_u16_to_u8:
//     v >> 8 level quantisation (256 levels from 65536), parallel.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Task {
  std::atomic<long> next{0};
};

template <typename F>
void parallel_for(long n, int num_threads, F&& fn) {
  if (n <= 0) return;
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  if (num_threads <= 0) num_threads = hw > 0 ? hw : 4;
  num_threads = static_cast<int>(std::min<long>(num_threads, n));
  if (num_threads <= 1) {
    for (long i = 0; i < n; ++i) fn(i);
    return;
  }
  Task task;
  std::vector<std::thread> threads;
  threads.reserve(num_threads);
  for (int t = 0; t < num_threads; ++t) {
    threads.emplace_back([&task, n, &fn]() {
      for (;;) {
        long i = task.next.fetch_add(1, std::memory_order_relaxed);
        if (i >= n) break;
        fn(i);
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Center crop/pad one (h, w, c) row-major source into out[H, W, c].
template <typename T>
void pack_one(const T* src, long h, long w, long c, T* out, long H, long W) {
  // source region (crop) and destination offset (pad), both centered
  long src_r0 = h > H ? (h - H) / 2 : 0;
  long src_c0 = w > W ? (w - W) / 2 : 0;
  long copy_h = std::min(h, H);
  long copy_w = std::min(w, W);
  long dst_r0 = H > h ? (H - h) / 2 : 0;
  long dst_c0 = W > w ? (W - w) / 2 : 0;

  std::memset(out, 0, sizeof(T) * H * W * c);
  for (long r = 0; r < copy_h; ++r) {
    const T* s = src + ((src_r0 + r) * w + src_c0) * c;
    T* d = out + ((dst_r0 + r) * W + dst_c0) * c;
    std::memcpy(d, s, sizeof(T) * copy_w * c);
  }
}

template <typename T>
void pack_batch(const T* const* srcs, const long* hs, const long* ws, long n,
                long c, T* out, long H, long W, int num_threads) {
  const long stride = H * W * c;
  parallel_for(n, num_threads, [&](long i) {
    pack_one<T>(srcs[i], hs[i], ws[i], c, out + i * stride, H, W);
  });
}

}  // namespace

extern "C" {

void tpumcia_pack_u8(const uint8_t* const* srcs, const long* hs,
                     const long* ws, long n, long c, uint8_t* out, long H,
                     long W, int num_threads) {
  pack_batch<uint8_t>(srcs, hs, ws, n, c, out, H, W, num_threads);
}

void tpumcia_pack_u16(const uint16_t* const* srcs, const long* hs,
                      const long* ws, long n, long c, uint16_t* out, long H,
                      long W, int num_threads) {
  pack_batch<uint16_t>(srcs, hs, ws, n, c, out, H, W, num_threads);
}

// 65536 -> `levels` quantisation: v * levels / 65536 (for levels=256: v >> 8).
void tpumcia_quantize_u16_to_u8(const uint16_t* src, uint8_t* dst, long n,
                                long levels, int num_threads) {
  const long block = 1 << 20;
  long num_blocks = (n + block - 1) / block;
  parallel_for(num_blocks, num_threads, [&](long b) {
    long lo = b * block;
    long hi = std::min(n, lo + block);
    if (levels == 256) {
      for (long i = lo; i < hi; ++i) dst[i] = static_cast<uint8_t>(src[i] >> 8);
    } else {
      for (long i = lo; i < hi; ++i) {
        long v = (static_cast<long>(src[i]) * levels) >> 16;
        dst[i] = static_cast<uint8_t>(v < levels ? v : levels - 1);
      }
    }
  });
}

}  // extern "C"
