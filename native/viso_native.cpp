// viso_native: host-side ingestion runtime for viso_tpu.
//
// Native replacement for the reference's synchronous loader
// (/root/reference/include/frame_sequence.h:25-38 — cv::imread on the
// render thread, one frame per tick) and its never-instantiated
// RingBuffer (include/ring_buffer.h:10-42). Provides:
//
//   * a minimal self-contained 8/16-bit PNG decoder (gray, RGB, palette
//     -> grayscale) over zlib, no OpenCV dependency,
//   * PGM (P5) decoding,
//   * a multi-threaded prefetcher that decodes ahead of the consumer
//     into a bounded in-order ring — so JPEG/PNG decode never blocks the
//     accelerator step loop.
//
// C ABI exposed for ctypes (viso_tpu/data/native.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ---------------------------------------------------------------------------
// Minimal PNG decoder (grayscale output).
// ---------------------------------------------------------------------------

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> gray;  // h*w
};

static uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Returns 0 on success.
static int decode_png_gray(const uint8_t* buf, size_t len, Image* out) {
  static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (len < 8 || memcmp(buf, kSig, 8) != 0) return 1;
  size_t pos = 8;
  int w = 0, h = 0, bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // rgb triples
  while (pos + 8 <= len) {
    uint32_t chunk_len = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = buf + pos + 8;
    if (pos + 12 + chunk_len > len) return 2;
    if (!memcmp(type, "IHDR", 4)) {
      if (chunk_len < 13) return 3;
      w = (int)be32(data);
      h = (int)be32(data + 4);
      bit_depth = data[8];
      color_type = data[9];
      interlace = data[12];
      if (interlace != 0) return 4;              // Adam7 unsupported
      if (bit_depth != 8 && bit_depth != 16) return 5;
    } else if (!memcmp(type, "PLTE", 4)) {
      palette.assign(data, data + chunk_len);
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + chunk_len);
    } else if (!memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + chunk_len;
  }
  if (w <= 0 || h <= 0 || idat.empty()) return 6;

  int channels;
  switch (color_type) {
    case 0: channels = 1; break;   // gray
    case 2: channels = 3; break;   // rgb
    case 3: channels = 1; break;   // palette
    case 4: channels = 2; break;   // gray+alpha
    case 6: channels = 4; break;   // rgba
    default: return 7;
  }
  const int bytes_per_sample = bit_depth / 8;
  const size_t stride = (size_t)w * channels * bytes_per_sample;
  std::vector<uint8_t> raw((stride + 1) * h);

  // zlib inflate.
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return 8;
  zs.next_in = idat.data();
  zs.avail_in = (uInt)idat.size();
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int zret = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (zret != Z_STREAM_END && zret != Z_OK) return 9;

  // Un-filter.
  const int bpp = channels * bytes_per_sample;
  std::vector<uint8_t> img((size_t)h * stride);
  const uint8_t* prev = nullptr;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = raw.data() + (size_t)y * (stride + 1);
    uint8_t filter = src[0];
    uint8_t* dst = img.data() + (size_t)y * stride;
    const uint8_t* s = src + 1;
    switch (filter) {
      case 0:
        memcpy(dst, s, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = s[x] + (x >= (size_t)bpp ? dst[x - bpp] : 0);
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = s[x] + (prev ? prev[x] : 0);
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= (size_t)bpp ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          dst[x] = s[x] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= (size_t)bpp ? dst[x - bpp] : 0;
          int b = prev ? prev[x] : 0;
          int c = (prev && x >= (size_t)bpp) ? prev[x - bpp] : 0;
          dst[x] = s[x] + paeth(a, b, c);
        }
        break;
      default:
        return 10;
    }
    prev = dst;
  }

  // Convert to 8-bit grayscale.
  out->w = w;
  out->h = h;
  out->gray.resize((size_t)w * h);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = img.data() + (size_t)y * stride;
    uint8_t* g = out->gray.data() + (size_t)y * w;
    for (int x = 0; x < w; ++x) {
      const uint8_t* px = row + (size_t)x * bpp;
      int v;
      if (color_type == 3) {
        int idx = px[0];
        if ((size_t)(idx * 3 + 2) < palette.size()) {
          int r = palette[idx * 3], gg = palette[idx * 3 + 1],
              b = palette[idx * 3 + 2];
          v = (r * 77 + gg * 150 + b * 29) >> 8;
        } else {
          v = 0;
        }
      } else if (channels >= 3) {
        int r = px[0 * bytes_per_sample], gg = px[1 * bytes_per_sample],
            b = px[2 * bytes_per_sample];
        v = (r * 77 + gg * 150 + b * 29) >> 8;
      } else {
        v = px[0];
      }
      g[x] = (uint8_t)v;
    }
  }
  return 0;
}

static int decode_pgm_gray(const uint8_t* buf, size_t len, Image* out) {
  if (len < 2 || buf[0] != 'P' || buf[1] != '5') return 1;
  size_t pos = 2;
  auto skip_ws = [&]() {
    while (pos < len) {
      if (buf[pos] == '#') {
        while (pos < len && buf[pos] != '\n') ++pos;
      } else if (isspace(buf[pos])) {
        ++pos;
      } else {
        break;
      }
    }
  };
  auto read_int = [&]() {
    skip_ws();
    long v = 0;
    while (pos < len && isdigit(buf[pos])) v = v * 10 + (buf[pos++] - '0');
    return v;
  };
  long w = read_int(), h = read_int(), maxv = read_int();
  ++pos;  // single whitespace after maxval
  if (w <= 0 || h <= 0 || maxv <= 0 || maxv > 65535) return 2;
  size_t need = (size_t)w * h * (maxv > 255 ? 2 : 1);
  if (pos + need > len) return 3;
  out->w = (int)w;
  out->h = (int)h;
  out->gray.resize((size_t)w * h);
  if (maxv > 255) {
    for (size_t i = 0; i < (size_t)w * h; ++i)
      out->gray[i] = buf[pos + 2 * i];  // big-endian high byte
  } else {
    memcpy(out->gray.data(), buf + pos, (size_t)w * h);
  }
  return 0;
}

static int decode_any(const uint8_t* buf, size_t len, Image* out) {
  if (len >= 8 && buf[0] == 137 && buf[1] == 'P') return decode_png_gray(buf, len, out);
  if (len >= 2 && buf[0] == 'P' && buf[1] == '5') return decode_pgm_gray(buf, len, out);
  return 100;
}

static int read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t rd = fread(out->data(), 1, n, f);
  fclose(f);
  return rd == (size_t)n ? 0 : 2;
}

// ---------------------------------------------------------------------------
// Prefetcher: N decode threads filling a bounded in-order ring.
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> paths;
  size_t ring_cap;
  std::vector<Image> slots;
  std::vector<std::atomic<int>> ready;  // 0=empty, 1=decoding, 2=ready, 3=error
  std::atomic<size_t> next_job{0};
  size_t next_out = 0;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv;

  Prefetcher(std::vector<std::string> p, size_t cap, int n_threads)
      : paths(std::move(p)),
        ring_cap(cap),
        slots(paths.size() < cap ? paths.size() : cap),
        ready(paths.size()) {
    for (auto& r : ready) r.store(0);
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { Work(); });
  }

  ~Prefetcher() {
    stop.store(true);
    cv.notify_all();
    for (auto& w : workers) w.join();
  }

  void Work() {
    while (!stop.load()) {
      size_t job = next_job.fetch_add(1);
      if (job >= paths.size()) return;
      // Bound the ring: wait until the consumer catches up.
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || job < next_out + ring_cap;
        });
        if (stop.load()) return;
      }
      Image img;
      std::vector<uint8_t> buf;
      int rc = read_file(paths[job].c_str(), &buf);
      if (rc == 0) rc = decode_any(buf.data(), buf.size(), &img);
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[job % ring_cap] = std::move(img);
        ready[job].store(rc == 0 ? 2 : 3);
      }
      cv.notify_all();
    }
  }

  // Returns 0 ok, 1 end-of-sequence, 2 decode error.
  int Next(float* out, int* w, int* h, int max_pixels) {
    if (next_out >= paths.size()) return 1;
    size_t job = next_out;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv.wait(lk, [&] { return ready[job].load() >= 2; });
    }
    int status = ready[job].load();
    Image& img = slots[job % ring_cap];
    if (status == 2 && img.w * img.h <= max_pixels) {
      *w = img.w;
      *h = img.h;
      const size_t n = (size_t)img.w * img.h;
      for (size_t i = 0; i < n; ++i) out[i] = (float)img.gray[i];
    } else {
      status = 3;
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      img = Image();
      ++next_out;
    }
    cv.notify_all();
    return status == 2 ? 0 : 2;
  }
};

}  // namespace

extern "C" {

// Decode a single file to float32 grayscale. Returns 0 on success and
// sets *w, *h; `out` must hold at least max_pixels floats.
int viso_decode_gray(const char* path, float* out, int* w, int* h,
                     int max_pixels) {
  std::vector<uint8_t> buf;
  if (read_file(path, &buf)) return 1;
  Image img;
  int rc = decode_any(buf.data(), buf.size(), &img);
  if (rc) return rc;
  if (img.w * img.h > max_pixels) return 101;
  *w = img.w;
  *h = img.h;
  const size_t n = (size_t)img.w * img.h;
  for (size_t i = 0; i < n; ++i) out[i] = (float)img.gray[i];
  return 0;
}

// Prefetcher lifecycle. `paths` is a NUL-joined, double-NUL-terminated
// list of n file paths.
void* viso_prefetcher_create(const char* paths, int n, int ring, int threads) {
  std::vector<std::string> list;
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    list.emplace_back(p);
    p += list.back().size() + 1;
  }
  return new Prefetcher(std::move(list), (size_t)ring, threads);
}

int viso_prefetcher_next(void* handle, float* out, int* w, int* h,
                         int max_pixels) {
  return static_cast<Prefetcher*>(handle)->Next(out, w, h, max_pixels);
}

void viso_prefetcher_destroy(void* handle) {
  delete static_cast<Prefetcher*>(handle);
}

}  // extern "C"
