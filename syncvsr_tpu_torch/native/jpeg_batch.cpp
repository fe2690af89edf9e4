// Threaded batch JPEG decoder for the data loader's hot path.
//
// Plays the role the reference delegated to libturbojpeg via PyTurboJPEG
// (LRW/video/src/data.py:13,41) but amortized: one call decodes every frame
// of a clip/batch in parallel worker threads straight into a caller-owned
// contiguous buffer — no per-frame Python round trips, no intermediate
// allocations. Built with plain libjpeg (present in the image); exposed to
// Python through ctypes (syncvsr_tpu/data/jpeg.py).
//
// Build: g++ -O3 -shared -fPIC -o libjpegbatch.so jpeg_batch.cpp -ljpeg -lpthread

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode one grayscale JPEG into out (out_h * out_w bytes). Frames smaller
// than the target are zero-padded bottom/right; larger ones are cropped.
// Returns 0 on success.
int decode_one(const uint8_t* buf, size_t size, uint8_t* out, int out_h,
               int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);

  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (w == out_w && h == out_h) {
    // exact-size fast path: decode straight into the output buffer
    std::vector<JSAMPROW> rows(h);
    for (int y = 0; y < h; ++y) rows[y] = out + static_cast<size_t>(y) * out_w;
    while (cinfo.output_scanline < cinfo.output_height) {
      jpeg_read_scanlines(&cinfo, rows.data() + cinfo.output_scanline,
                          cinfo.output_height - cinfo.output_scanline);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 0;
  }
  const int copy_w = w < out_w ? w : out_w;
  std::vector<uint8_t> row(w);
  JSAMPROW rows[1] = {row.data()};
  std::memset(out, 0, static_cast<size_t>(out_h) * out_w);
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = static_cast<int>(cinfo.output_scanline);
    jpeg_read_scanlines(&cinfo, rows, 1);
    if (y < out_h) {
      std::memcpy(out + static_cast<size_t>(y) * out_w, row.data(), copy_w);
    }
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// bufs: n pointers to JPEG byte strings; sizes: their lengths.
// out: n * out_h * out_w contiguous uint8 buffer.
// Returns 0 on success, or 1 + index of the first frame that failed.
int decode_gray_batch(const uint8_t** bufs, const size_t* sizes, int n,
                      uint8_t* out, int out_h, int out_w, int n_threads) {
  if (n <= 0) return 0;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  std::atomic<int> failed(0);
  const size_t frame_bytes = static_cast<size_t>(out_h) * out_w;

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n || failed.load() != 0) return;
      if (decode_one(bufs[i], sizes[i], out + frame_bytes * i, out_h, out_w)) {
        int expected = 0;
        failed.compare_exchange_strong(expected, i + 1);
        return;
      }
    }
  };

  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failed.load();
}

}  // extern "C"
