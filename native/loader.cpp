// uwslam-tpu native data loader.
//
// Equivalent of the reference's C++ frame-ingest runtime
// (/root/reference/src/System.cpp:225-262 AddFrame: blocking cv::imread in
// the main loop). Here decoding runs on a worker thread pool with a bounded
// ring of pre-decoded float32 frames, so host I/O overlaps device compute.
//
// Formats: PNG (8/16-bit gray or RGB via libpng16), JPEG (libjpeg), PGM (P2/P5).
// All decode to float32 grayscale [0,255]; 16-bit PNG keeps raw values
// (the TUM depth convention — caller applies the 0.0002 factor,
// reference src/Tracker.cpp:1223).
//
// C ABI (consumed by uwslam_tpu/io/native.py via ctypes):
//   uws_decode(path, out, cap, *w, *h) -> 0 ok / <0 error
//   uws_loader_create(paths, n, lookahead, threads) -> handle
//   uws_loader_next(handle, out, cap, *index, *w, *h) -> 0 ok / 1 eos / <0 err
//   uws_loader_destroy(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Frame {
  std::vector<float> data;
  int width = 0;
  int height = 0;
  int index = -1;
  bool ok = false;
};

// ---------------------------------------------------------------- PNG decode
bool decode_png(FILE* f, Frame* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);

  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  png_set_strip_alpha(png);
  // 16-bit stays 16-bit (depth images); big-endian in PNG -> swap.
  if (bit_depth == 16) png_set_swap(png);
  png_read_update_info(png, info);

  color = png_get_color_type(png, info);
  bit_depth = png_get_bit_depth(png, info);
  int channels = png_get_channels(png, info);

  std::vector<png_byte> row(png_get_rowbytes(png, info));
  out->width = static_cast<int>(w);
  out->height = static_cast<int>(h);
  out->data.resize(static_cast<size_t>(w) * h);

  for (png_uint_32 y = 0; y < h; ++y) {
    png_read_row(png, row.data(), nullptr);
    float* dst = out->data.data() + static_cast<size_t>(y) * w;
    if (bit_depth == 16) {
      const uint16_t* src = reinterpret_cast<const uint16_t*>(row.data());
      if (channels == 1) {
        for (png_uint_32 x = 0; x < w; ++x) dst[x] = static_cast<float>(src[x]);
      } else {
        for (png_uint_32 x = 0; x < w; ++x) {
          const uint16_t* p = src + x * channels;
          dst[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
        }
      }
    } else {
      const uint8_t* src = row.data();
      if (channels == 1) {
        for (png_uint_32 x = 0; x < w; ++x) dst[x] = static_cast<float>(src[x]);
      } else {
        for (png_uint_32 x = 0; x < w; ++x) {
          const uint8_t* p = src + x * channels;
          dst[x] = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
        }
      }
    }
  }
  png_read_end(png, nullptr);
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// --------------------------------------------------------------- JPEG decode
bool decode_jpeg(FILE* f, Frame* out) {
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  out->width = cinfo.output_width;
  out->height = cinfo.output_height;
  out->data.resize(static_cast<size_t>(out->width) * out->height);
  std::vector<uint8_t> row(out->width);
  uint8_t* rowp = row.data();
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
    float* dst = out->data.data() + static_cast<size_t>(y) * out->width;
    for (int x = 0; x < out->width; ++x) dst[x] = static_cast<float>(row[x]);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------- PGM decode
bool decode_pgm(FILE* f, Frame* out) {
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) return false;
  bool binary = strcmp(magic, "P5") == 0;
  if (!binary && strcmp(magic, "P2") != 0) return false;
  int w = 0, h = 0, maxv = 0;
  // Skip comments.
  auto read_int = [&](int* v) {
    int c;
    while ((c = fgetc(f)) != EOF) {
      if (c == '#') {
        while ((c = fgetc(f)) != EOF && c != '\n') {
        }
      } else if (!isspace(c)) {
        ungetc(c, f);
        break;
      }
    }
    return fscanf(f, "%d", v) == 1;
  };
  if (!read_int(&w) || !read_int(&h) || !read_int(&maxv)) return false;
  fgetc(f);  // single whitespace after header
  out->width = w;
  out->height = h;
  out->data.resize(static_cast<size_t>(w) * h);
  if (binary) {
    if (maxv < 256) {
      std::vector<uint8_t> buf(static_cast<size_t>(w) * h);
      if (fread(buf.data(), 1, buf.size(), f) != buf.size()) return false;
      for (size_t i = 0; i < buf.size(); ++i)
        out->data[i] = static_cast<float>(buf[i]);
    } else {
      std::vector<uint16_t> buf(static_cast<size_t>(w) * h);
      if (fread(buf.data(), 2, buf.size() / 1, f) != buf.size()) return false;
      for (size_t i = 0; i < buf.size(); ++i) {
        uint16_t v = buf[i];
        out->data[i] = static_cast<float>((v >> 8) | (v << 8));  // big-endian
      }
    }
  } else {
    for (size_t i = 0; i < out->data.size(); ++i) {
      int v;
      if (fscanf(f, "%d", &v) != 1) return false;
      out->data[i] = static_cast<float>(v);
    }
  }
  return true;
}

bool decode_file(const std::string& path, Frame* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  uint8_t sig[8] = {0};
  size_t n = fread(sig, 1, 8, f);
  rewind(f);
  bool ok = false;
  if (n >= 8 && png_sig_cmp(sig, 0, 8) == 0) {
    ok = decode_png(f, out);
  } else if (n >= 2 && sig[0] == 0xFF && sig[1] == 0xD8) {
    ok = decode_jpeg(f, out);
  } else if (n >= 2 && sig[0] == 'P' && (sig[1] == '2' || sig[1] == '5')) {
    ok = decode_pgm(f, out);
  }
  fclose(f);
  out->ok = ok;
  return ok;
}

// ------------------------------------------------------------------- Loader
class Loader {
 public:
  Loader(std::vector<std::string> paths, int lookahead, int threads)
      : paths_(std::move(paths)),
        lookahead_(std::max(lookahead, 1)),
        next_to_decode_(0),
        next_to_emit_(0),
        stop_(false) {
    int n = std::max(1, threads);
    for (int i = 0; i < n; ++i) {
      workers_.emplace_back([this] { Work(); });
    }
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_work_.notify_all();
    cv_ready_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // 0 ok, 1 end-of-stream, -1 decode error, -2 buffer too small.
  int Next(float* out, int64_t cap, int* index, int* w, int* h) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_ready_.wait(lk, [this] {
      return stop_ || done_.count(next_to_emit_) > 0 ||
             next_to_emit_ >= static_cast<int>(paths_.size());
    });
    if (next_to_emit_ >= static_cast<int>(paths_.size())) return 1;
    Frame fr = std::move(done_[next_to_emit_]);
    done_.erase(next_to_emit_);
    *index = next_to_emit_;
    ++next_to_emit_;
    cv_work_.notify_all();
    lk.unlock();

    if (!fr.ok) return -1;
    int64_t need = static_cast<int64_t>(fr.width) * fr.height;
    if (need > cap) return -2;
    std::memcpy(out, fr.data.data(), need * sizeof(float));
    *w = fr.width;
    *h = fr.height;
    return 0;
  }

 private:
  void Work() {
    for (;;) {
      int idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_work_.wait(lk, [this] {
          return stop_ ||
                 (next_to_decode_ < static_cast<int>(paths_.size()) &&
                  next_to_decode_ - next_to_emit_ < lookahead_);
        });
        if (stop_) return;
        if (next_to_decode_ >= static_cast<int>(paths_.size())) return;
        idx = next_to_decode_++;
      }
      Frame fr;
      fr.index = idx;
      decode_file(paths_[idx], &fr);
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_[idx] = std::move(fr);
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  int lookahead_;
  int next_to_decode_;
  int next_to_emit_;
  bool stop_;
  std::map<int, Frame> done_;
  std::mutex mu_;
  std::condition_variable cv_work_, cv_ready_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

int uws_decode(const char* path, float* out, int64_t cap, int* w, int* h) {
  Frame fr;
  if (!decode_file(path, &fr)) return -1;
  int64_t need = static_cast<int64_t>(fr.width) * fr.height;
  if (need > cap) return -2;
  std::memcpy(out, fr.data.data(), need * sizeof(float));
  *w = fr.width;
  *h = fr.height;
  return 0;
}

void* uws_loader_create(const char** paths, int n, int lookahead, int threads) {
  std::vector<std::string> v(paths, paths + n);
  return new Loader(std::move(v), lookahead, threads);
}

int uws_loader_next(void* handle, float* out, int64_t cap, int* index, int* w,
                    int* h) {
  return static_cast<Loader*>(handle)->Next(out, cap, index, w, h);
}

void uws_loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
