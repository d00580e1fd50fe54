// Native RLDS shard reader: the TPU-host replacement for the C++ tf.data
// runtime the reference leans on (SURVEY.md §2.3). Provides:
//   - TFRecord record framing with crc32c (SSE4.2 hardware CRC when
//     available, table fallback)
//   - a minimal tf.train.Example wire parser (bytes/float/int64 lists)
//   - JPEG decode fused with area resize to the model input size: through
//     libjpeg (with its DCT scaling), or, built with -DRLDS_NVJPEG where
//     the host has no libjpeg, through nvJPEG on the GPU (the CUDA
//     toolkit's; a full-size decode, then the same area resize on the host)
//   - a multithreaded prefetching record pipeline over a list of shards
// Exposed as a C ABI for ctypes (no pybind11 dependency).
//
// Built by data/native.py (g++, into the package's _build/); the decode
// route in use is rlds_decode_path().

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <cmath>
#include <setjmp.h>

#ifdef RLDS_NVJPEG
#include <cuda_runtime.h>
#include <nvjpeg.h>
#else
#include <jpeglib.h>
#endif

// ---------------------------------------------------------------------------
// crc32c
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[256];
static bool g_crc_init = false;

static void crc_table_init() {
  if (g_crc_init) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    g_crc_table[i] = c;
  }
  g_crc_init = true;
}

#if defined(__SSE4_2__)
#include <nmmintrin.h>
static uint32_t crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = 0xFFFFFFFFu;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t v;
    memcpy(&v, data + i, 8);
    crc = (uint32_t)_mm_crc32_u64(crc, v);
  }
  for (; i < n; i++) crc = _mm_crc32_u8(crc, data[i]);
  return crc ^ 0xFFFFFFFFu;
}
#else
static uint32_t crc32c(const uint8_t* data, size_t n) {
  crc_table_init();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++)
    crc = g_crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}
#endif

static uint32_t masked_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// proto wire parsing
// ---------------------------------------------------------------------------

struct Slice {
  const uint8_t* p;
  size_t n;
};

static bool read_varint(Slice& s, uint64_t* out) {
  uint64_t r = 0;
  int shift = 0;
  while (s.n) {
    uint8_t b = *s.p;
    s.p++;
    s.n--;
    r |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = r;
      return true;
    }
    shift += 7;
    if (shift > 63) return false;
  }
  return false;
}

static bool skip_field(Slice& s, uint32_t wt) {
  uint64_t v;
  switch (wt) {
    case 0: return read_varint(s, &v);
    case 1: if (s.n < 8) return false; s.p += 8; s.n -= 8; return true;
    case 2:
      if (!read_varint(s, &v) || s.n < v) return false;
      s.p += v; s.n -= v; return true;
    case 5: if (s.n < 4) return false; s.p += 4; s.n -= 4; return true;
    default: return false;
  }
}

static bool read_ld(Slice& s, Slice* out) {
  uint64_t len;
  if (!read_varint(s, &len) || s.n < len) return false;
  out->p = s.p;
  out->n = len;
  s.p += len;
  s.n -= len;
  return true;
}

struct Feature {
  int type = 0;  // 1 bytes, 2 float, 3 int64
  std::vector<Slice> bytes_vals;     // views into the record buffer
  std::vector<float> float_vals;
  std::vector<int64_t> int_vals;
};

struct ParsedExample {
  std::vector<uint8_t> owned;  // copy of the payload (slices point here)
  std::unordered_map<std::string, Feature> features;
};

static void parse_feature(Slice s, Feature* f) {
  while (s.n) {
    uint64_t tag;
    if (!read_varint(s, &tag)) return;
    uint32_t field = tag >> 3, wt = tag & 7;
    if (wt != 2) { if (!skip_field(s, wt)) return; continue; }
    Slice sub;
    if (!read_ld(s, &sub)) return;
    if (field == 1) {  // BytesList
      f->type = 1;
      while (sub.n) {
        uint64_t t2;
        if (!read_varint(sub, &t2)) return;
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {
          Slice v;
          if (!read_ld(sub, &v)) return;
          f->bytes_vals.push_back(v);
        } else if (!skip_field(sub, t2 & 7)) return;
      }
    } else if (field == 2) {  // FloatList
      f->type = 2;
      while (sub.n) {
        uint64_t t2;
        if (!read_varint(sub, &t2)) return;
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {
          Slice v;
          if (!read_ld(sub, &v)) return;
          size_t cnt = v.n / 4;
          size_t base = f->float_vals.size();
          f->float_vals.resize(base + cnt);
          memcpy(f->float_vals.data() + base, v.p, cnt * 4);
        } else if ((t2 >> 3) == 1 && (t2 & 7) == 5) {
          if (sub.n < 4) return;  // truncated record: bail like read_ld does
          float fv;
          memcpy(&fv, sub.p, 4);
          sub.p += 4; sub.n -= 4;
          f->float_vals.push_back(fv);
        } else if (!skip_field(sub, t2 & 7)) return;
      }
    } else if (field == 3) {  // Int64List
      f->type = 3;
      while (sub.n) {
        uint64_t t2;
        if (!read_varint(sub, &t2)) return;
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {
          Slice v;
          if (!read_ld(sub, &v)) return;
          while (v.n) {
            uint64_t iv;
            if (!read_varint(v, &iv)) return;
            f->int_vals.push_back((int64_t)iv);
          }
        } else if ((t2 >> 3) == 1 && (t2 & 7) == 0) {
          uint64_t iv;
          if (!read_varint(sub, &iv)) return;
          f->int_vals.push_back((int64_t)iv);
        } else if (!skip_field(sub, t2 & 7)) return;
      }
    }
  }
}

static void parse_example_into(ParsedExample* pe) {
  Slice s{pe->owned.data(), pe->owned.size()};
  while (s.n) {
    uint64_t tag;
    if (!read_varint(s, &tag)) return;
    if ((tag >> 3) != 1 || (tag & 7) != 2) { if (!skip_field(s, tag & 7)) return; continue; }
    Slice feats;
    if (!read_ld(s, &feats)) return;
    while (feats.n) {
      uint64_t ftag;
      if (!read_varint(feats, &ftag)) return;
      if ((ftag >> 3) != 1 || (ftag & 7) != 2) { if (!skip_field(feats, ftag & 7)) return; continue; }
      Slice entry;
      if (!read_ld(feats, &entry)) return;
      std::string key;
      Feature feat;
      while (entry.n) {
        uint64_t etag;
        if (!read_varint(entry, &etag)) return;
        uint32_t ef = etag >> 3, ewt = etag & 7;
        if (ef == 1 && ewt == 2) {
          Slice k;
          if (!read_ld(entry, &k)) return;
          key.assign((const char*)k.p, k.n);
        } else if (ef == 2 && ewt == 2) {
          Slice v;
          if (!read_ld(entry, &v)) return;
          parse_feature(v, &feat);
        } else if (!skip_field(entry, ewt)) return;
      }
      if (!key.empty()) pe->features.emplace(std::move(key), std::move(feat));
    }
  }
}

// ---------------------------------------------------------------------------
// threaded shard reader
// ---------------------------------------------------------------------------

struct Record {
  std::vector<uint8_t> data;
};

struct RldsReader {
  std::vector<std::string> paths;
  std::deque<Record> queue;
  std::deque<ParsedExample*> pqueue;  // parse_in_worker mode
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t capacity;
  bool verify_crc;
  bool parse_in_worker = false;  // workers parse tf.Examples off-GIL and the
                                 // payload is moved (not copied) into the
                                 // ParsedExample
  std::atomic<size_t> next_file{0};
  std::atomic<int> live_workers{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  Record current;  // last record handed to the caller

  size_t queued() const { return queue.size() + pqueue.size(); }

  void worker() {
    while (!stop.load()) {
      size_t idx = next_file.fetch_add(1);
      if (idx >= paths.size()) break;
      FILE* f = fopen(paths[idx].c_str(), "rb");
      if (!f) continue;
      uint8_t header[8], crcbuf[4];
      while (!stop.load()) {
        if (fread(header, 1, 8, f) != 8) break;
        uint64_t len;
        memcpy(&len, header, 8);
        // corrupt/non-TFRecord shards yield garbage lengths; a throwing
        // resize() inside a worker thread would std::terminate the whole
        // process — skip the shard like every other malformed-read path
        // (1 GiB is far above any real RLDS episode)
        if (len > (uint64_t)1 << 30) break;
        if (fread(crcbuf, 1, 4, f) != 4) break;
        if (verify_crc) {
          uint32_t hc;
          memcpy(&hc, crcbuf, 4);
          if (masked_crc32c(header, 8) != hc) break;
        }
        Record rec;
        rec.data.resize(len);
        if (fread(rec.data.data(), 1, len, f) != len) break;
        if (fread(crcbuf, 1, 4, f) != 4) break;
        if (verify_crc) {
          uint32_t pc;
          memcpy(&pc, crcbuf, 4);
          if (masked_crc32c(rec.data.data(), len) != pc) break;
        }
        ParsedExample* pe = nullptr;
        if (parse_in_worker) {
          pe = new ParsedExample();
          pe->owned = std::move(rec.data);
          parse_example_into(pe);
        }
        std::unique_lock<std::mutex> lk(mu);
        cv_push.wait(lk, [&] { return queued() < capacity || stop.load(); });
        if (stop.load()) { delete pe; break; }
        if (parse_in_worker) pqueue.push_back(pe);
        else queue.push_back(std::move(rec));
        cv_pop.notify_one();
      }
      fclose(f);
    }
    if (live_workers.fetch_sub(1) == 1) {
      std::lock_guard<std::mutex> lk(mu);
      cv_pop.notify_all();
    }
  }
};

extern "C" {

RldsReader* rlds_reader_open(const char** paths, int n, int n_threads,
                             int queue_capacity, int verify_crc) {
  auto* r = new RldsReader();
  for (int i = 0; i < n; i++) r->paths.emplace_back(paths[i]);
  r->capacity = queue_capacity > 0 ? (size_t)queue_capacity : 64;
  r->verify_crc = verify_crc != 0;
  int nt = n_threads > 0 ? n_threads : 1;
  r->live_workers = nt;
  for (int i = 0; i < nt; i++) r->workers.emplace_back(&RldsReader::worker, r);
  return r;
}

// Returns length of the next record (data valid until the next call), or -1
// when the stream is exhausted.
long rlds_reader_next(RldsReader* r, const uint8_t** data) {
  std::unique_lock<std::mutex> lk(r->mu);
  r->cv_pop.wait(lk, [&] {
    return !r->queue.empty() || r->live_workers.load() == 0;
  });
  if (r->queue.empty()) return -1;
  r->current = std::move(r->queue.front());
  r->queue.pop_front();
  r->cv_push.notify_one();
  *data = r->current.data.data();
  return (long)r->current.data.size();
}

void rlds_reader_close(RldsReader* r) {
  r->stop.store(true);
  r->cv_push.notify_all();
  r->cv_pop.notify_all();
  for (auto& t : r->workers) t.join();
  for (ParsedExample* pe : r->pqueue) delete pe;
  delete r;
}

// Like rlds_reader_open but the worker threads also parse each tf.Example
// (off the consumer thread / Python GIL) and the record payload is moved into
// the parsed representation instead of copied. Consume with
// rlds_reader_next_parsed; each returned ParsedExample must be freed with
// rlds_parsed_free.
RldsReader* rlds_reader_open_parsed(const char** paths, int n, int n_threads,
                                    int queue_capacity, int verify_crc) {
  auto* r = new RldsReader();
  for (int i = 0; i < n; i++) r->paths.emplace_back(paths[i]);
  r->capacity = queue_capacity > 0 ? (size_t)queue_capacity : 64;
  r->verify_crc = verify_crc != 0;
  r->parse_in_worker = true;
  int nt = n_threads > 0 ? n_threads : 1;
  r->live_workers = nt;
  for (int i = 0; i < nt; i++) r->workers.emplace_back(&RldsReader::worker, r);
  return r;
}

// -- example parsing --------------------------------------------------------

ParsedExample* rlds_parse(const uint8_t* data, long len) {
  auto* pe = new ParsedExample();
  pe->owned.assign(data, data + len);
  parse_example_into(pe);
  return pe;
}

// type: 1 bytes, 2 float, 3 int64; count: number of values. Returns 0 if
// the key is absent.
int rlds_feature_info(ParsedExample* pe, const char* key, long* count) {
  auto it = pe->features.find(key);
  if (it == pe->features.end()) return 0;
  const Feature& f = it->second;
  if (f.type == 1) *count = (long)f.bytes_vals.size();
  else if (f.type == 2) *count = (long)f.float_vals.size();
  else *count = (long)f.int_vals.size();
  return f.type;
}

int rlds_feature_floats(ParsedExample* pe, const char* key, float* out) {
  auto it = pe->features.find(key);
  if (it == pe->features.end() || it->second.type != 2) return -1;
  memcpy(out, it->second.float_vals.data(), it->second.float_vals.size() * 4);
  return 0;
}

int rlds_feature_ints(ParsedExample* pe, const char* key, long long* out) {
  auto it = pe->features.find(key);
  if (it == pe->features.end() || it->second.type != 3) return -1;
  memcpy(out, it->second.int_vals.data(), it->second.int_vals.size() * 8);
  return 0;
}

long rlds_feature_bytes_len(ParsedExample* pe, const char* key, int index) {
  auto it = pe->features.find(key);
  if (it == pe->features.end() || it->second.type != 1) return -1;
  if (index < 0 || (size_t)index >= it->second.bytes_vals.size()) return -1;
  return (long)it->second.bytes_vals[index].n;
}

int rlds_feature_bytes(ParsedExample* pe, const char* key, int index,
                       uint8_t* out) {
  auto it = pe->features.find(key);
  if (it == pe->features.end() || it->second.type != 1) return -1;
  const Slice& s = it->second.bytes_vals[index];
  memcpy(out, s.p, s.n);
  return 0;
}

void rlds_parsed_free(ParsedExample* pe) { delete pe; }

// Pop the next record and parse it in one call — the payload never makes a
// round-trip through Python (saves a string_at copy + a from_buffer_copy per
// episode). With rlds_reader_open_parsed the parse already happened on a
// worker thread and this just pops the result. Returns NULL at end of
// stream. The caller owns the ParsedExample (rlds_parsed_free).
ParsedExample* rlds_reader_next_parsed(RldsReader* r) {
  if (r->parse_in_worker) {
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv_pop.wait(lk, [&] {
      return !r->pqueue.empty() || r->live_workers.load() == 0;
    });
    if (r->pqueue.empty()) return nullptr;
    ParsedExample* pe = r->pqueue.front();
    r->pqueue.pop_front();
    r->cv_push.notify_one();
    return pe;
  }
  const uint8_t* data = nullptr;
  long n = rlds_reader_next(r, &data);
  if (n < 0) return nullptr;
  return rlds_parse(data, n);
}

// Newline-joined feature keys; returns the total byte length needed. Writes
// only when cap is large enough (caller retries with a bigger buffer).
long rlds_keys(ParsedExample* pe, uint8_t* out, long cap) {
  long total = 0;
  for (const auto& kv : pe->features) total += (long)kv.first.size() + 1;
  if (out != nullptr && cap >= total) {
    uint8_t* p = out;
    for (const auto& kv : pe->features) {
      memcpy(p, kv.first.data(), kv.first.size());
      p += kv.first.size();
      *p++ = '\n';
    }
  }
  return total;
}

// Batched bytes extraction (one crossing for all lengths, one for all
// payloads — vs 2 crossings *per value* with rlds_feature_bytes_len/bytes).
// Fills lens[count] and returns the concatenated total, or -1 on a missing /
// non-bytes key.
long rlds_feature_bytes_lens(ParsedExample* pe, const char* key,
                             long long* lens) {
  auto it = pe->features.find(key);
  if (it == pe->features.end() || it->second.type != 1) return -1;
  long total = 0;
  const auto& vals = it->second.bytes_vals;
  for (size_t i = 0; i < vals.size(); i++) {
    lens[i] = (long long)vals[i].n;
    total += (long)vals[i].n;
  }
  return total;
}

int rlds_feature_bytes_concat(ParsedExample* pe, const char* key,
                              uint8_t* out) {
  auto it = pe->features.find(key);
  if (it == pe->features.end() || it->second.type != 1) return -1;
  for (const Slice& s : it->second.bytes_vals) {
    memcpy(out, s.p, s.n);
    out += s.n;
  }
  return 0;
}

// -- jpeg decode + resize ---------------------------------------------------

// area (box) resize of an RGB uint8 image (H, W) to (out_h, out_w)
static void box_resize(const uint8_t* src, int H, int W, int out_h, int out_w,
                       uint8_t* out_rgb) {
  for (int oy = 0; oy < out_h; oy++) {
    int y0 = (int)((int64_t)oy * H / out_h);
    int y1 = (int)((int64_t)(oy + 1) * H / out_h);
    if (y1 <= y0) y1 = y0 + 1;
    for (int ox = 0; ox < out_w; ox++) {
      int x0 = (int)((int64_t)ox * W / out_w);
      int x1 = (int)((int64_t)(ox + 1) * W / out_w);
      if (x1 <= x0) x1 = x0 + 1;
      uint32_t acc[3] = {0, 0, 0};
      for (int y = y0; y < y1; y++)
        for (int x = x0; x < x1; x++) {
          const uint8_t* px = src + ((size_t)y * W + x) * 3;
          acc[0] += px[0];
          acc[1] += px[1];
          acc[2] += px[2];
        }
      uint32_t cnt = (uint32_t)((y1 - y0) * (x1 - x0));
      uint8_t* dst = out_rgb + ((size_t)oy * out_w + ox) * 3;
      dst[0] = (uint8_t)(acc[0] / cnt);
      dst[1] = (uint8_t)(acc[1] / cnt);
      dst[2] = (uint8_t)(acc[2] / cnt);
    }
  }
}

// libjpeg's YCbCr -> RGB conversion (jdcolor.c: build_ycc_rgb_table and
// ycc_rgb_convert, 16-bit fixed point), for decoders that return planes
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
};

[[maybe_unused]] static const YccTables& ycc_tables() {
  static const YccTables t = [] {
    YccTables t;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int32_t x = i - 128;
      t.cr_r[i] = (int)((fix(1.40200) * x + 32768) >> 16);
      t.cb_b[i] = (int)((fix(1.77200) * x + 32768) >> 16);
      t.cr_g[i] = -fix(0.71414) * x;
      t.cb_g[i] = -fix(0.34414) * x + 32768;
    }
    return t;
  }();
  return t;
}

static inline uint8_t clamp_u8(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// One chroma plane upsampled to (W, H) as libjpeg-turbo's jdsample.c does it
// with its default fancy upsampling: the triangle filters h2v1_fancy_upsample
// and h2v2_fancy_upsample (for planes wider than 2 samples), and
// h1v2_fancy_upsample, the plane's first and last rows repeated beyond its
// edges as libjpeg's context rows are; every other integer factor up to 4
// (4:1:1, 4:1:0, and 2x at 2 samples wide) repeats each sample (int_upsample).
// Returns false for other factors, and for a plane that, upsampled, would
// not cover (W, H).
[[maybe_unused]] static bool upsample_plane(const uint8_t* in, size_t pitch, int cw, int ch,
                                            int hs, int vs, int W, int H, uint8_t* out) {
  if (hs < 1 || hs > 4 || vs < 1 || vs > 4 || (long)cw * hs < W || (long)ch * vs < H)
    return false;
  std::vector<uint8_t> row((size_t)cw * hs);
  for (int y = 0; y < H; y++) {
    uint8_t* o = row.data();
    int r = y / vs;
    if (vs == 2 && (hs == 1 || (hs == 2 && cw > 2))) {
      // the nearer input row and the next nearest (clamped at the edges)
      int far = (y % 2 == 0) ? r - 1 : r + 1;
      if (far < 0) far = 0;
      if (far > ch - 1) far = ch - 1;
      const uint8_t* p0 = in + (size_t)r * pitch;
      const uint8_t* p1 = in + (size_t)far * pitch;
      if (hs == 1) {
        int bias = (y % 2 == 0) ? 1 : 2;
        for (int c = 0; c < cw; c++) *o++ = (uint8_t)((p0[c] * 3 + p1[c] + bias) >> 2);
      } else {
        int this_sum = p0[0] * 3 + p1[0], next_sum = p0[1] * 3 + p1[1], last_sum;
        *o++ = (uint8_t)((this_sum * 4 + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
        for (int c = 2; c < cw; c++) {
          next_sum = p0[c] * 3 + p1[c];
          *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          *o++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        *o++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *o++ = (uint8_t)((this_sum * 4 + 7) >> 4);
      }
    } else if (hs == 2 && vs == 1 && cw > 2) {
      const uint8_t* p = in + (size_t)r * pitch;
      int v = p[0];
      *o++ = (uint8_t)v;
      *o++ = (uint8_t)((v * 3 + p[1] + 2) >> 2);
      for (int c = 1; c < cw - 1; c++) {
        v = p[c] * 3;
        *o++ = (uint8_t)((v + p[c - 1] + 1) >> 2);
        *o++ = (uint8_t)((v + p[c + 1] + 2) >> 2);
      }
      v = p[cw - 1];
      *o++ = (uint8_t)((v * 3 + p[cw - 2] + 1) >> 2);
      *o++ = (uint8_t)v;
    } else {
      const uint8_t* p = in + (size_t)r * pitch;
      for (int c = 0; c < cw; c++)
        for (int k = 0; k < hs; k++) *o++ = p[c];
    }
    memcpy(out + (size_t)y * W, row.data(), W);
  }
  return true;
}

// Planar Y (W x H) and Cb, Cr (cw x ch, subsampled hs x vs) -> interleaved
// RGB as libjpeg gives it; a null Cb means grayscale. False for factors that
// upsample_plane does not take.
[[maybe_unused]] static bool ycc_planes_to_rgb(const uint8_t* y, size_t y_pitch,
                                               const uint8_t* cb, const uint8_t* cr,
                                               size_t c_pitch, int cw, int ch, int hs, int vs,
                                               int W, int H, uint8_t* rgb) {
  if (!cb) {
    for (int r = 0; r < H; r++)
      for (int c = 0; c < W; c++) {
        uint8_t v = y[(size_t)r * y_pitch + c];
        uint8_t* px = rgb + ((size_t)r * W + c) * 3;
        px[0] = px[1] = px[2] = v;
      }
    return true;
  }
  std::vector<uint8_t> up_cb((size_t)W * H), up_cr((size_t)W * H);
  if (!upsample_plane(cb, c_pitch, cw, ch, hs, vs, W, H, up_cb.data()) ||
      !upsample_plane(cr, c_pitch, cw, ch, hs, vs, W, H, up_cr.data()))
    return false;
  const YccTables& t = ycc_tables();
  for (int r = 0; r < H; r++)
    for (int c = 0; c < W; c++) {
      size_t i = (size_t)r * W + c;
      int Y = y[(size_t)r * y_pitch + c], b = up_cb[i], q = up_cr[i];
      uint8_t* px = rgb + i * 3;
      px[0] = clamp_u8(Y + t.cr_r[q]);
      px[1] = clamp_u8(Y + (int)((t.cb_g[b] + t.cr_g[q]) >> 16));
      px[2] = clamp_u8(Y + t.cb_b[b]);
    }
  return true;
}

#ifdef RLDS_NVJPEG

// One decoder per concurrent caller: nvJPEG's handle is shared, but a JPEG
// state, its stream and its buffers serve one decode at a time. Decoders are
// taken from a free list and returned after the decode; they live as long
// as the process.
struct NvDecoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  uint8_t* dev = nullptr;   // the decoded planes (or interleaved RGB)
  uint8_t* host = nullptr;  // their pinned copy
  size_t cap = 0;
  std::vector<uint8_t> rgb;  // the full-size RGB image of a planar decode
};

static std::mutex g_nv_mu;
static nvjpegHandle_t g_nv_handle = nullptr;
static int g_nv_device = 0;
static std::vector<NvDecoder*> g_nv_free;

static NvDecoder* nv_take() {
  std::lock_guard<std::mutex> lk(g_nv_mu);
  if (cudaSetDevice(g_nv_device) != cudaSuccess) return nullptr;
  if (!g_nv_handle && nvjpegCreateSimple(&g_nv_handle) != NVJPEG_STATUS_SUCCESS) {
    g_nv_handle = nullptr;
    return nullptr;
  }
  if (!g_nv_free.empty()) {
    NvDecoder* d = g_nv_free.back();
    g_nv_free.pop_back();
    return d;
  }
  NvDecoder* d = new NvDecoder();
  if (nvjpegJpegStateCreate(g_nv_handle, &d->state) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking) != cudaSuccess) {
    delete d;  // (a state made before a failed stream is left to the process)
    return nullptr;
  }
  return d;
}

static void nv_give(NvDecoder* d) {
  std::lock_guard<std::mutex> lk(g_nv_mu);
  g_nv_free.push_back(d);
}

static bool nv_reserve(NvDecoder* d, size_t need) {
  if (need <= d->cap) return true;
  if (d->dev) cudaFree(d->dev);
  if (d->host) cudaFreeHost(d->host);
  d->dev = nullptr;
  d->host = nullptr;
  d->cap = 0;
  if (cudaMalloc((void**)&d->dev, need) != cudaSuccess) return false;
  if (cudaMallocHost((void**)&d->host, need) != cudaSuccess) return false;
  d->cap = need;
  return true;
}

// Decode on the GPU and copy back to d->host; returns the RGB image (H, W)
// or null. Grayscale, 4:4:4, 4:2:2, 4:2:0, 4:4:0, 4:1:1 and 4:1:0 images come
// back as planes and are upsampled and converted to RGB on the host as
// libjpeg does it; other subsamplings take nvJPEG's own RGB output.
static const uint8_t* nv_decode(NvDecoder* d, const uint8_t* jpeg, long len, int* H,
                                int* W) {
  if (cudaSetDevice(g_nv_device) != cudaSuccess) return nullptr;
  int n_comp = 0;
  nvjpegChromaSubsampling_t sub;
  int widths[NVJPEG_MAX_COMPONENT], heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(g_nv_handle, jpeg, (size_t)len, &n_comp, &sub, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return nullptr;
  *W = widths[0];
  *H = heights[0];
  if (*W <= 0 || *H <= 0) return nullptr;
  // the chroma factors from the subsampling nvJPEG reports; the planes'
  // sizes must be what they give, else nvJPEG's own RGB output is taken
  int hs = 0, vs = 0;
  switch (sub) {
    case NVJPEG_CSS_444: hs = 1; vs = 1; break;
    case NVJPEG_CSS_422: hs = 2; vs = 1; break;
    case NVJPEG_CSS_420: hs = 2; vs = 2; break;
    case NVJPEG_CSS_440: hs = 1; vs = 2; break;
    case NVJPEG_CSS_411: hs = 4; vs = 1; break;
    case NVJPEG_CSS_410: hs = 4; vs = 2; break;
    default: break;
  }
  bool planar = n_comp == 1 && sub == NVJPEG_CSS_GRAY;
  if (n_comp == 3 && hs > 0)
    planar = widths[1] == widths[2] && heights[1] == heights[2] &&
             widths[1] == (*W + hs - 1) / hs && heights[1] == (*H + vs - 1) / vs;
  size_t y_bytes = (size_t)(*W) * (*H);
  size_t c_bytes = n_comp == 3 ? (size_t)widths[1] * heights[1] : 0;
  size_t need = planar ? y_bytes + 2 * c_bytes : y_bytes * 3;
  if (!nv_reserve(d, need)) return nullptr;
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = d->dev;
  if (planar) {
    img.pitch[0] = (size_t)(*W);
    if (n_comp == 3) {
      for (int c = 1; c < 3; c++) {
        img.channel[c] = d->dev + y_bytes + (c - 1) * c_bytes;
        img.pitch[c] = (size_t)widths[1];
      }
    }
  } else {
    img.pitch[0] = (size_t)(*W) * 3;
  }
  nvjpegOutputFormat_t fmt = !planar ? NVJPEG_OUTPUT_RGBI
                             : (n_comp == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV);
  if (nvjpegDecode(g_nv_handle, d->state, jpeg, (size_t)len, fmt, &img, d->stream) !=
      NVJPEG_STATUS_SUCCESS)
    return nullptr;
  if (cudaMemcpyAsync(d->host, d->dev, need, cudaMemcpyDeviceToHost, d->stream) !=
          cudaSuccess ||
      cudaStreamSynchronize(d->stream) != cudaSuccess)
    return nullptr;
  if (!planar) return d->host;
  d->rgb.resize(y_bytes * 3);
  const uint8_t* cb = n_comp == 3 ? d->host + y_bytes : nullptr;
  if (!ycc_planes_to_rgb(d->host, (size_t)(*W), cb, cb ? cb + c_bytes : nullptr,
                         (size_t)widths[1], widths[1], heights[1], hs, vs, *W, *H,
                         d->rgb.data()))
    return nullptr;
  return d->rgb.data();
}

const char* rlds_decode_path() { return "nvjpeg"; }

// The GPU that nvJPEG decodes on (default 0); set before the first decode.
void rlds_set_decode_device(int device) {
  std::lock_guard<std::mutex> lk(g_nv_mu);
  g_nv_device = device;
}

// Decode JPEG on the GPU (nvJPEG, full size: no DCT scaling; the chroma
// upsampled and converted to RGB on the host as libjpeg does it) and
// area-resize to (out_h, out_w) RGB uint8 on the host. Returns 0 on success.
int rlds_decode_jpeg_resize(const uint8_t* jpeg, long len, int out_h,
                            int out_w, uint8_t* out_rgb) {
  NvDecoder* d = nv_take();
  if (!d) return -1;
  int H = 0, W = 0;
  const uint8_t* rgb = nv_decode(d, jpeg, len, &H, &W);
  if (rgb) box_resize(rgb, H, W, out_h, out_w, out_rgb);
  nv_give(d);
  return rgb ? 0 : -1;
}

// The decode above: nvJPEG's planes are upsampled and converted on the host.
int rlds_decode_jpeg_resize_planar(const uint8_t* jpeg, long len, int out_h, int out_w,
                                   uint8_t* out_rgb) {
  return rlds_decode_jpeg_resize(jpeg, len, out_h, out_w, out_rgb);
}

#else  // libjpeg

struct JpegErr {
  struct jpeg_error_mgr pub;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  auto* e = (JpegErr*)cinfo->err;
  longjmp(e->jb, 1);
}

const char* rlds_decode_path() { return "libjpeg"; }

// libjpeg decodes on the calling thread: there is no device to choose.
void rlds_set_decode_device(int) {}

// Decode JPEG and area-resize to (out_h, out_w) RGB uint8. Uses libjpeg's
// fractional DCT scaling to get close to the target cheaply, then a box
// filter for the remainder. Returns 0 on success.
int rlds_decode_jpeg_resize(const uint8_t* jpeg, long len, int out_h,
                            int out_w, uint8_t* out_rgb) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(jpeg), (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.out_color_space = JCS_RGB;
  // pick the SMALLEST DCT scale N/8 whose decoded size stays >= target —
  // libjpeg then skips most of the IDCT work (640x480 -> 224x224 decodes
  // at 4/8 = 320x240: ~4x fewer pixels than a full decode). Mild scales
  // (5/8..7/8) route libjpeg onto its slower scaled-IDCT kernels for
  // little pixel savings, so only engage at <= 4/8; otherwise decode full.
  for (int num = 1; num <= 8; num++) {
    cinfo.scale_num = num;
    cinfo.scale_denom = 8;
    jpeg_calc_output_dimensions(&cinfo);
    if ((int)cinfo.output_height >= out_h && (int)cinfo.output_width >= out_w)
      break;
  }
  if (cinfo.scale_num > 4) {
    cinfo.scale_num = 8;
    jpeg_calc_output_dimensions(&cinfo);
  }
  jpeg_start_decompress(&cinfo);
  int H = cinfo.output_height, W = cinfo.output_width;
  std::vector<uint8_t> buf((size_t)H * W * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + (size_t)cinfo.output_scanline * W * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  box_resize(buf.data(), H, W, out_h, out_w, out_rgb);
  return 0;
}

// The nvJPEG route's host half over libjpeg's planes, so that a host
// without a GPU checks it: a full-size decode to the planes (raw data,
// chroma at its stored subsampling), upsampled and converted by
// ycc_planes_to_rgb, then the area resize. Returns 0 on success, 1 for a
// subsampling the planar path does not take, -1 on a decode error.
int rlds_decode_jpeg_resize_planar(const uint8_t* jpeg, long len, int out_h, int out_w,
                                   uint8_t* out_rgb) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(jpeg), (unsigned long)len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK ||
      (cinfo.num_components != 1 && cinfo.num_components != 3)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  int W = cinfo.output_width, H = cinfo.output_height, nc = cinfo.num_components;
  int vmax = cinfo.max_v_samp_factor;
  std::vector<std::vector<uint8_t>> planes(nc);
  std::vector<size_t> pitch(nc);
  for (int c = 0; c < nc; c++) {
    const jpeg_component_info* ci = &cinfo.comp_info[c];
    pitch[c] = (size_t)ci->width_in_blocks * DCTSIZE;
    planes[c].assign(pitch[c] * (ci->height_in_blocks + ci->v_samp_factor) * DCTSIZE, 0);
  }
  std::vector<JSAMPROW> rows[3];
  JSAMPARRAY arrays[3];
  while (cinfo.output_scanline < cinfo.output_height) {
    int y = cinfo.output_scanline;  // a multiple of vmax * DCTSIZE
    for (int c = 0; c < nc; c++) {
      int v = cinfo.comp_info[c].v_samp_factor, n = v * DCTSIZE, base = y / vmax * v;
      rows[c].resize(n);
      for (int i = 0; i < n; i++) rows[c][i] = planes[c].data() + (size_t)(base + i) * pitch[c];
      arrays[c] = rows[c].data();
    }
    jpeg_read_raw_data(&cinfo, arrays, (JDIMENSION)(vmax * DCTSIZE));
  }
  int cw = 0, ch = 0, hs = 1, vs = 1;
  if (nc == 3) {
    cw = cinfo.comp_info[1].downsampled_width;
    ch = cinfo.comp_info[1].downsampled_height;
    hs = cinfo.max_h_samp_factor / cinfo.comp_info[1].h_samp_factor;
    vs = cinfo.max_v_samp_factor / cinfo.comp_info[1].v_samp_factor;
    for (int c = 1; c < 3; c++)  // both chroma planes at one integer factor
      if (cinfo.comp_info[c].h_samp_factor * hs != cinfo.max_h_samp_factor ||
          cinfo.comp_info[c].v_samp_factor * vs != cinfo.max_v_samp_factor ||
          cinfo.comp_info[0].h_samp_factor != cinfo.max_h_samp_factor ||
          cinfo.comp_info[0].v_samp_factor != cinfo.max_v_samp_factor)
        hs = 0;
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::vector<uint8_t> rgb((size_t)W * H * 3);
  const uint8_t* cb = nc == 3 ? planes[1].data() : nullptr;
  if (!ycc_planes_to_rgb(planes[0].data(), pitch[0], cb, nc == 3 ? planes[2].data() : nullptr,
                         nc == 3 ? pitch[1] : 0, cw, ch, hs, vs, W, H, rgb.data()))
    return 1;
  box_resize(rgb.data(), H, W, out_h, out_w, out_rgb);
  return 0;
}

#endif  // RLDS_NVJPEG

uint32_t rlds_crc32c(const uint8_t* data, long len) {
  return crc32c(data, (size_t)len);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// fused photometric augmentation
// ---------------------------------------------------------------------------

extern "C" {

// In-place-style augmentation of a decoded RGB frame:
//   1. bilinear-resize the crop box (cy, cx, ch, cw) back to (H, W)
//   2. brightness += b_delta (in [0,255] scale)
//   3. contrast: (x - mean) * c_factor + mean (per-channel mean)
//   4. saturation: gray + (x - gray) * s_factor (Rec.601 gray)
//   5. hue: arithmetic HSV rotation by h_delta (fraction of a turn)
// Matches data/augment.py (the reference's fixed photometric recipe).
int rlds_augment(const uint8_t* in, int H, int W, uint8_t* out, int cy,
                 int cx, int ch, int cw, float b_delta, float c_factor,
                 float s_factor, float h_delta) {
  if (ch <= 0 || cw <= 0 || cy < 0 || cx < 0 || cy + ch > H || cx + cw > W)
    return -1;
  std::vector<float> buf((size_t)H * W * 3);
  // bilinear resize of the crop to (H, W) (half-pixel centers); x-axis
  // interpolation coordinates precomputed once per image so the hot inner
  // loop carries no divides
  std::vector<int> xs0(W), xs1(W);
  std::vector<float> wxs(W);
  for (int ox = 0; ox < W; ox++) {
    float sx = ((ox + 0.5f) * cw) / W - 0.5f;
    if (sx < 0) sx = 0;
    if (sx > cw - 1) sx = (float)(cw - 1);
    int x0 = (int)sx;
    xs0[ox] = x0;
    xs1[ox] = x0 + 1 < cw ? x0 + 1 : cw - 1;
    wxs[ox] = sx - x0;
  }
  double mean[3] = {0, 0, 0};
  for (int oy = 0; oy < H; oy++) {
    float sy = ((oy + 0.5f) * ch) / H - 0.5f;
    if (sy < 0) sy = 0;
    if (sy > ch - 1) sy = (float)(ch - 1);
    int y0 = (int)sy;
    int y1 = y0 + 1 < ch ? y0 + 1 : ch - 1;
    float wy = sy - y0;
    const uint8_t* row0 = in + (((size_t)(cy + y0) * W) + cx) * 3;
    const uint8_t* row1 = in + (((size_t)(cy + y1) * W) + cx) * 3;
    double rsum = 0, gsum = 0, bsum = 0;
    for (int ox = 0; ox < W; ox++) {
      const uint8_t* p00 = row0 + (size_t)xs0[ox] * 3;
      const uint8_t* p01 = row0 + (size_t)xs1[ox] * 3;
      const uint8_t* p10 = row1 + (size_t)xs0[ox] * 3;
      const uint8_t* p11 = row1 + (size_t)xs1[ox] * 3;
      float wx = wxs[ox];
      float* dst = buf.data() + ((size_t)oy * W + ox) * 3;
      float v0 = (1 - wy) * ((1 - wx) * p00[0] + wx * p01[0]) +
                 wy * ((1 - wx) * p10[0] + wx * p11[0]);
      float v1 = (1 - wy) * ((1 - wx) * p00[1] + wx * p01[1]) +
                 wy * ((1 - wx) * p10[1] + wx * p11[1]);
      float v2 = (1 - wy) * ((1 - wx) * p00[2] + wx * p01[2]) +
                 wy * ((1 - wx) * p10[2] + wx * p11[2]);
      dst[0] = v0;
      dst[1] = v1;
      dst[2] = v2;
      rsum += v0;
      gsum += v1;
      bsum += v2;
    }
    mean[0] += rsum;
    mean[1] += gsum;
    mean[2] += bsum;
  }
  float m[3];
  // contrast recenters around the POST-brightness per-channel mean
  // (data/augment.py:random_contrast runs after random_brightness);
  // mean(x + d) == mean(x) + d, so shift the accumulated means
  for (int c = 0; c < 3; c++)
    m[c] = (float)(mean[c] / ((double)H * W)) + b_delta;

  for (size_t i = 0; i < (size_t)H * W; i++) {
    float* px = buf.data() + i * 3;
    float r = px[0] + b_delta, g = px[1] + b_delta, b = px[2] + b_delta;
    r = (r - m[0]) * c_factor + m[0];
    g = (g - m[1]) * c_factor + m[1];
    b = (b - m[2]) * c_factor + m[2];
    float gray = 0.299f * r + 0.587f * g + 0.114f * b;
    r = gray + (r - gray) * s_factor;
    g = gray + (g - gray) * s_factor;
    b = gray + (b - gray) * s_factor;
    if (h_delta != 0.0f) {
      // clip to [0,255] before the HSV conversion (augment.py:random_hue
      // clips; post-brightness/contrast values can be outside the range)
      float rc = fminf(fmaxf(r, 0.0f), 255.0f);
      float gc = fminf(fmaxf(g, 0.0f), 255.0f);
      float bc = fminf(fmaxf(b, 0.0f), 255.0f);
      float r01 = rc * (1.0f / 255.0f), g01 = gc * (1.0f / 255.0f),
            b01 = bc * (1.0f / 255.0f);
      float mx = fmaxf(r01, fmaxf(g01, b01));
      float mn = fminf(r01, fminf(g01, b01));
      float diff = mx - mn;
      float inv_diff = diff > 0.0f ? 1.0f / diff : 0.0f;
      float h;
      if (diff <= 0.0f) {
        h = 0.0f;
      } else if (mx == r01) {
        h = (g01 - b01) * inv_diff;  // (-6, 6): wrap below
        if (h < 0.0f) h += 6.0f;
      } else if (mx == g01) {
        h = (b01 - r01) * inv_diff + 2.0f;
      } else {
        h = (r01 - g01) * inv_diff + 4.0f;
      }
      h = h * (1.0f / 6.0f) + h_delta + 1.0f;  // (0, 3)
      h -= (float)(int)h;                      // frac -> [0, 1)
      float s = mx > 0 ? diff / mx : 0.0f;
      float h6 = h * 6.0f;
      auto chan = [&](float n) {
        float k = n + h6;  // [1, 12)
        if (k >= 6.0f) k -= 6.0f;
        float t = fminf(k, 4.0f - k);
        t = fmaxf(0.0f, fminf(1.0f, t));
        return (mx - mx * s * t) * 255.0f;
      };
      r = chan(5.0f);
      g = chan(3.0f);
      b = chan(1.0f);
    }
    uint8_t* dst = out + i * 3;
    dst[0] = (uint8_t)fmaxf(0.0f, fminf(255.0f, r));
    dst[1] = (uint8_t)fmaxf(0.0f, fminf(255.0f, g));
    dst[2] = (uint8_t)fmaxf(0.0f, fminf(255.0f, b));
  }
  return 0;
}

}  // extern "C"
