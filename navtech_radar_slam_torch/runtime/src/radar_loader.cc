// Native radar scan loader of the PyTorch port: PNG decode on zlib alone,
// metadata strip and a threaded in-order prefetcher.
//
// The counterpart of navtech_radar_slam_tpu/runtime/src/radar_loader.cc,
// with its C interface function for function (consumed through ctypes by
// navtech_radar_slam_torch/runtime/loader.py).  A pool of worker threads
// decodes the scans of a sequence ahead of the consumer into a bounded set
// of buffers (power as raw bytes or normalised float32, zero-padded to
// padded_range_bins), so the consumer only copies a ready scan out.
//
// Format (oxford-radar-robotcar polar form, as MulRan ships it):
//   row = azimuth (400 rows), cols 0-7 int64 LE timestamp, cols 8-9 uint16
//   azimuth encoder tick (of 5600), col 10 validity, cols 11+ uint8 power.
//
// Where it differs from the JAX package's loader:
//   * The PNG decoder is written here on zlib (inflate, then the five row
//     filters), not on libpng.  It reads exactly the files the port's Python
//     decoder (data/png.py) reads: 8-bit greyscale, non-interlaced, any row
//     filter, every chunk CRC checked; anything else is an error.
//   * A scan that fails to read or decode is an error, carried through
//     radar_loader_next with a code and a message; it never ends the
//     sequence early.
//   * The arithmetic is data/mulran.py::decode_polar_scan's, so both scan
//     sources give the same arrays bit for bit: float power is byte / 255
//     (a division, not a multiplication by 1/255), the ns-or-us choice of
//     the ray stamps is made once per scan from its largest stamp, and an
//     image must have exactly num_azimuths rows.
//
// Return codes of next / decode: 0 a scan, -1 the end of the sequence, > 0
// an errno value (ENOENT and the like from opening the file, EIO for a file
// that is not a readable scan) with the reason in the caller's err buffer
// (empty when the code says it all).

#include <zlib.h>

#include <algorithm>
#include <cerrno>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kEncoderSize = 5600;
constexpr uint8_t kSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

struct LoaderConfig {
  int num_azimuths;
  int num_range_bins;
  int padded_range_bins;
  int meta_columns;
  int num_workers;
  int queue_capacity;
  // raw_u8: power as the raw PNG bytes; the consumer normalises on the device
  bool raw_u8;
};

struct Status {
  int code = 0;     // 0 ok, else an errno value
  std::string msg;  // the reason; empty when strerror(code) says it
};

bool Fail(Status* st, int code, std::string msg) {
  st->code = code;
  st->msg = std::move(msg);
  return false;
}

struct DecodedScan {
  int64_t index = -1;
  Status status;
  std::vector<float> power;        // num_azimuths * padded_range_bins (float mode)
  std::vector<uint8_t> power_u8;   // the same shape (raw_u8 mode)
  std::vector<double> timestamps;  // num_azimuths
  std::vector<float> azimuths;     // num_azimuths
  std::vector<uint8_t> valid;      // num_azimuths
};

struct GrayImage {
  uint32_t width = 0;
  uint32_t height = 0;
  std::vector<uint8_t> data;  // row-major, height * width
};

bool ReadFile(const char* path, std::vector<uint8_t>* out, Status* st) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return Fail(st, errno, "");
  out->clear();
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), fp)) > 0)
    out->insert(out->end(), buf, buf + n);
  const bool err = std::ferror(fp) != 0;
  std::fclose(fp);
  if (err) return Fail(st, EIO, "read error");
  return true;
}

uint32_t Be32(const uint8_t* p) {
  return (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16) | (uint32_t{p[2]} << 8) |
         uint32_t{p[3]};
}

std::string ChunkName(const uint8_t* kind) {
  std::string s;
  for (int i = 0; i < 4; ++i) {
    const char c = static_cast<char>(kind[i]);
    s += (c >= 0x20 && c < 0x7f) ? c : '?';
  }
  return s;
}

uint8_t Paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

// PNG bytes -> 8-bit greyscale image, with data/png.py::decode_png's rules.
bool DecodePng(const std::vector<uint8_t>& file, GrayImage* img, Status* st) {
  if (file.size() < 8 || std::memcmp(file.data(), kSignature, 8) != 0)
    return Fail(st, EIO, "not a PNG file");
  bool have_header = false, have_end = false;
  uint8_t depth = 0, color = 0, compression = 0, filter = 0, interlace = 0;
  std::vector<uint8_t> idat;
  size_t pos = 8;
  while (pos + 12 <= file.size()) {
    const uint32_t len = Be32(&file[pos]);
    const uint8_t* kind = &file[pos + 4];
    if (len > file.size() - pos - 12)
      return Fail(st, EIO, "corrupt PNG chunk " + ChunkName(kind));
    const uint8_t* payload = &file[pos + 8];
    uLong crc = crc32(0L, kind, 4);
    crc = crc32(crc, payload, len);
    if (crc != Be32(payload + len))
      return Fail(st, EIO, "corrupt PNG chunk " + ChunkName(kind));
    if (std::memcmp(kind, "IHDR", 4) == 0) {
      if (len != 13) return Fail(st, EIO, "PNG IHDR chunk of " + std::to_string(len) + " bytes");
      img->width = Be32(payload);
      img->height = Be32(payload + 4);
      depth = payload[8];
      color = payload[9];
      compression = payload[10];
      filter = payload[11];
      interlace = payload[12];
      have_header = true;
    } else if (std::memcmp(kind, "IDAT", 4) == 0) {
      idat.insert(idat.end(), payload, payload + len);
    } else if (std::memcmp(kind, "IEND", 4) == 0) {
      have_end = true;
      break;
    }
    pos += 12 + size_t{len};
  }
  if (!have_end) return Fail(st, EIO, "PNG ends without an IEND chunk");
  if (!have_header) return Fail(st, EIO, "PNG without an IHDR chunk");
  if (depth != 8 || color != 0)
    return Fail(st, EIO, "only 8-bit greyscale PNGs are read (bit depth " +
                             std::to_string(depth) + ", colour type " + std::to_string(color) + ")");
  if (interlace != 0 || compression != 0 || filter != 0)
    return Fail(st, EIO, "only non-interlaced PNGs are read (interlace " +
                             std::to_string(interlace) + ", compression " +
                             std::to_string(compression) + ", filter method " +
                             std::to_string(filter) + ")");

  // inflate the whole stream; the data must be exactly one filter byte and
  // width pixels per row.  The buffer grows with the data, never to what a
  // corrupt header claims.
  const uint64_t stride = uint64_t{img->width} + 1;
  const uint64_t expect = stride * img->height;
  std::vector<uint8_t> raw(static_cast<size_t>(std::min<uint64_t>(expect + 1, 1u << 22)));
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return Fail(st, ENOMEM, "zlib inflateInit failed");
  zs.next_in = idat.data();
  zs.avail_in = static_cast<uInt>(idat.size());
  int rc = Z_OK;
  while (rc == Z_OK) {
    if (zs.total_out == raw.size()) {
      if (raw.size() > expect) break;  // more data than the rows hold
      raw.resize(static_cast<size_t>(std::min<uint64_t>(expect + 1, 2 * uint64_t{raw.size()})));
    }
    zs.next_out = raw.data() + zs.total_out;
    zs.avail_out = static_cast<uInt>(raw.size() - zs.total_out);
    rc = inflate(&zs, Z_NO_FLUSH);
    if (rc == Z_BUF_ERROR && zs.avail_in == 0 && zs.avail_out != 0) break;  // truncated
    if (rc == Z_BUF_ERROR) rc = Z_OK;
  }
  const uint64_t got = zs.total_out;
  const std::string zmsg = zs.msg ? zs.msg : "";
  inflateEnd(&zs);
  if (rc != Z_STREAM_END) {
    if (got > expect)
      return Fail(st, EIO, "more than " + std::to_string(expect) + " bytes of image data for " +
                               std::to_string(img->height) + " rows of " +
                               std::to_string(img->width) + " pixels");
    return Fail(st, EIO, rc == Z_OK || rc == Z_BUF_ERROR
                             ? std::string("truncated image data")
                             : "corrupt image data (zlib: " + zmsg + ")");
  }
  if (got != expect)
    return Fail(st, EIO, std::to_string(got) + " bytes of image data for " +
                             std::to_string(img->height) + " rows of " +
                             std::to_string(img->width) + " pixels");

  // undo the row filters
  const size_t w = img->width;
  img->data.assign(size_t{img->height} * w, 0);
  const std::vector<uint8_t> zeros(w, 0);
  for (size_t r = 0; r < img->height; ++r) {
    const uint8_t kind = raw[r * stride];
    const uint8_t* in = &raw[r * stride + 1];
    uint8_t* out = img->data.data() + r * w;
    const uint8_t* up = r ? out - w : zeros.data();
    switch (kind) {
      case 0:
        std::memcpy(out, in, w);
        break;
      case 1:
        for (size_t i = 0; i < w; ++i) out[i] = static_cast<uint8_t>(in[i] + (i ? out[i - 1] : 0));
        break;
      case 2:
        for (size_t i = 0; i < w; ++i) out[i] = static_cast<uint8_t>(in[i] + up[i]);
        break;
      case 3:
        for (size_t i = 0; i < w; ++i)
          out[i] = static_cast<uint8_t>(in[i] + (((i ? out[i - 1] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < w; ++i)
          out[i] = static_cast<uint8_t>(
              in[i] + Paeth(i ? out[i - 1] : 0, up[i], i ? up[i - 1] : 0));
        break;
      default:
        return Fail(st, EIO, "unknown PNG row filter " + std::to_string(kind));
    }
  }
  return true;
}

// Strip the metadata columns and pad, into caller buffers:
// data/mulran.py::decode_polar_scan's arithmetic.
bool FillScan(const GrayImage& img, const LoaderConfig& cfg, void* power, double* timestamps,
              float* azimuths, uint8_t* valid, Status* st) {
  const int na = cfg.num_azimuths;
  const int nb = cfg.num_range_bins;
  const size_t pb = static_cast<size_t>(cfg.padded_range_bins);
  if (img.height != static_cast<uint32_t>(na))
    return Fail(st, EIO, "expected " + std::to_string(na) + " azimuth rows, got " +
                             std::to_string(img.height));
  const bool has_meta = img.width > static_cast<uint32_t>(nb);
  if (has_meta && img.width < static_cast<uint32_t>(std::max(cfg.meta_columns, 11)))
    return Fail(st, EIO, "an image of " + std::to_string(img.width) +
                             " columns cannot hold the metadata columns");
  const int data_off = has_meta ? cfg.meta_columns : 0;
  const int w = std::max(0, std::min<int>(nb, static_cast<int>(img.width) - data_off));
  if (has_meta) {
    // MulRan stamps are ns if huge, else us (oxford): decided per scan
    double most = 0.0;
    for (int a = 0; a < na; ++a) {
      int64_t stamp;
      std::memcpy(&stamp, img.data.data() + size_t(a) * img.width, 8);  // little-endian host
      timestamps[a] = static_cast<double>(stamp);
      most = a ? std::max(most, timestamps[a]) : timestamps[a];
    }
    const double scale = most > 1e17 ? 1e-9 : 1e-6;
    for (int a = 0; a < na; ++a) timestamps[a] *= scale;
  }
  for (int a = 0; a < na; ++a) {
    const uint8_t* row = img.data.data() + size_t(a) * img.width;
    if (has_meta) {
      uint16_t enc;
      std::memcpy(&enc, row + 8, 2);
      azimuths[a] = static_cast<float>(enc) / static_cast<float>(kEncoderSize) *
                    6.283185307179586f;
      valid[a] = row[10] != 0;
    } else {
      timestamps[a] = 0.0;
      azimuths[a] = (static_cast<float>(a) + 0.5f) / static_cast<float>(na) *
                    6.283185307179586f;
      valid[a] = 1;
    }
    const uint8_t* src = row + data_off;
    if (cfg.raw_u8) {
      uint8_t* dst = static_cast<uint8_t*>(power) + size_t(a) * pb;
      std::memcpy(dst, src, size_t(w));
      std::memset(dst + w, 0, pb - size_t(w));
    } else {
      float* dst = static_cast<float*>(power) + size_t(a) * pb;
      for (int r = 0; r < w; ++r) dst[r] = static_cast<float>(src[r]) / 255.0f;
      std::fill(dst + w, dst + pb, 0.0f);
    }
  }
  return true;
}

// Read, decode and strip one file into caller buffers; never throws.
bool LoadScan(const char* path, const LoaderConfig& cfg, void* power, double* timestamps,
              float* azimuths, uint8_t* valid, Status* st) {
  try {
    std::vector<uint8_t> file;
    GrayImage img;
    return ReadFile(path, &file, st) && DecodePng(file, &img, st) &&
           FillScan(img, cfg, power, timestamps, azimuths, valid, st);
  } catch (const std::exception& e) {
    return Fail(st, ENOMEM, std::string("decode failed: ") + e.what());
  }
}

int Report(const Status& st, char* err, int err_cap) {
  if (err && err_cap > 0) {
    const size_t n = std::min(st.msg.size(), static_cast<size_t>(err_cap - 1));
    std::memcpy(err, st.msg.data(), n);
    err[n] = '\0';
  }
  return st.code;
}

class Prefetcher {
 public:
  Prefetcher(std::vector<std::string> paths, const LoaderConfig& cfg)
      : paths_(std::move(paths)), cfg_(cfg) {
    try {
      for (int i = 0; i < cfg.num_workers; ++i) threads_.emplace_back([this] { Work(); });
    } catch (...) {
      Stop();  // join the workers that did start
      throw;
    }
  }

  ~Prefetcher() { Stop(); }

  // Blocks until the next scan in order is ready and copies it into the
  // caller's buffers (power is float* or uint8_t* by the mode).  Returns 0,
  // -1 at the end, or the scan's error code (its index in index_out).
  int Next(void* power, double* timestamps, float* azimuths, uint8_t* valid,
           int64_t* index_out, char* err, int err_cap) {
    std::unique_lock<std::mutex> lk(mu_);
    if (next_consume_ >= static_cast<int64_t>(paths_.size())) return -1;
    cv_ready_.wait(lk, [this] { return stop_ || ready_.count(next_consume_) > 0; });
    if (stop_) return -1;
    DecodedScan scan = std::move(ready_[next_consume_]);
    ready_.erase(next_consume_);
    ++next_consume_;
    lk.unlock();
    cv_space_.notify_all();

    *index_out = scan.index;
    if (scan.status.code != 0) return Report(scan.status, err, err_cap);
    if (cfg_.raw_u8)
      std::memcpy(power, scan.power_u8.data(), scan.power_u8.size());
    else
      std::memcpy(power, scan.power.data(), scan.power.size() * sizeof(float));
    std::memcpy(timestamps, scan.timestamps.data(), scan.timestamps.size() * sizeof(double));
    std::memcpy(azimuths, scan.azimuths.data(), scan.azimuths.size() * sizeof(float));
    std::memcpy(valid, scan.valid.data(), scan.valid.size());
    return 0;
  }

 private:
  void Stop() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_ready_.notify_all();
    cv_space_.notify_all();
    for (auto& t : threads_) t.join();
    threads_.clear();
  }

  void Work() {
    const size_t na = static_cast<size_t>(cfg_.num_azimuths);
    const size_t cells = na * static_cast<size_t>(cfg_.padded_range_bins);
    for (;;) {
      int64_t idx;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return stop_ || (next_fetch_ < static_cast<int64_t>(paths_.size()) &&
                           next_fetch_ - next_consume_ < cfg_.queue_capacity);
        });
        if (stop_) return;
        idx = next_fetch_++;
      }
      DecodedScan scan;
      scan.index = idx;
      try {
        if (cfg_.raw_u8)
          scan.power_u8.resize(cells);
        else
          scan.power.resize(cells);
        scan.timestamps.resize(na);
        scan.azimuths.resize(na);
        scan.valid.resize(na);
        void* power = cfg_.raw_u8 ? static_cast<void*>(scan.power_u8.data())
                                  : static_cast<void*>(scan.power.data());
        LoadScan(paths_[idx].c_str(), cfg_, power, scan.timestamps.data(),
                 scan.azimuths.data(), scan.valid.data(), &scan.status);
      } catch (const std::exception& e) {
        Fail(&scan.status, ENOMEM, std::string("decode failed: ") + e.what());
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        ready_[idx] = std::move(scan);
      }
      cv_ready_.notify_all();
    }
  }

  std::vector<std::string> paths_;
  LoaderConfig cfg_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_ready_;
  std::condition_variable cv_space_;
  std::map<int64_t, DecodedScan> ready_;
  int64_t next_fetch_ = 0;
  int64_t next_consume_ = 0;
  bool stop_ = false;
};

void* Create(const char** paths, int num_paths, const LoaderConfig& cfg) {
  if (num_paths < 0 || cfg.num_workers < 1 || cfg.queue_capacity < 1) return nullptr;
  try {
    std::vector<std::string> p(paths, paths + num_paths);
    return new Prefetcher(std::move(p), cfg);
  } catch (const std::exception&) {
    return nullptr;
  }
}

}  // namespace

extern "C" {

void* radar_loader_create(const char** paths, int num_paths, int num_azimuths,
                          int num_range_bins, int padded_range_bins, int meta_columns,
                          int num_workers, int queue_capacity) {
  return Create(paths, num_paths,
                LoaderConfig{num_azimuths, num_range_bins, padded_range_bins, meta_columns,
                             num_workers, queue_capacity, false});
}

// raw_u8 variant: power buffers hold the raw PNG bytes (uint8)
void* radar_loader_create_u8(const char** paths, int num_paths, int num_azimuths,
                             int num_range_bins, int padded_range_bins, int meta_columns,
                             int num_workers, int queue_capacity) {
  return Create(paths, num_paths,
                LoaderConfig{num_azimuths, num_range_bins, padded_range_bins, meta_columns,
                             num_workers, queue_capacity, true});
}

int radar_loader_next(void* handle, float* power, double* timestamps, float* azimuths,
                      uint8_t* valid, int64_t* index_out, char* err, int err_cap) {
  return static_cast<Prefetcher*>(handle)->Next(power, timestamps, azimuths, valid, index_out,
                                                err, err_cap);
}

int radar_loader_next_u8(void* handle, uint8_t* power, double* timestamps, float* azimuths,
                         uint8_t* valid, int64_t* index_out, char* err, int err_cap) {
  return static_cast<Prefetcher*>(handle)->Next(power, timestamps, azimuths, valid, index_out,
                                                err, err_cap);
}

void radar_loader_destroy(void* handle) { delete static_cast<Prefetcher*>(handle); }

// one-shot decode (no prefetcher), for random access and tests
int radar_decode_png(const char* path, int num_azimuths, int num_range_bins,
                     int padded_range_bins, int meta_columns, float* power, double* timestamps,
                     float* azimuths, uint8_t* valid, char* err, int err_cap) {
  const LoaderConfig cfg{num_azimuths, num_range_bins, padded_range_bins, meta_columns, 0, 0,
                         false};
  Status st;
  LoadScan(path, cfg, power, timestamps, azimuths, valid, &st);
  return Report(st, err, err_cap);
}

int radar_decode_png_u8(const char* path, int num_azimuths, int num_range_bins,
                        int padded_range_bins, int meta_columns, uint8_t* power,
                        double* timestamps, float* azimuths, uint8_t* valid, char* err,
                        int err_cap) {
  const LoaderConfig cfg{num_azimuths, num_range_bins, padded_range_bins, meta_columns, 0, 0,
                         true};
  Status st;
  LoadScan(path, cfg, power, timestamps, azimuths, valid, &st);
  return Report(st, err, err_cap);
}

}  // extern "C"
