// Native Criteo data pipeline: streaming TSV parser + frequency-relabel preprocessor.
//
// The port's own copy of `openembedding_tpu/native/oetpu_data.cpp` (the port
// shares no file with the JAX package). Counterpart of the reference's native
// data path: the C++ relabel preprocessor (`test/criteo_preprocess.cpp`) and
// the interleaved tf.data readers feeding the benchmark
// (`test/benchmark/criteo_deepctr.py:168-240`). The host-side parse must stay
// off the critical path; a Python row parser tops out around ~0.2M rows/s
// while this pipeline (1 IO thread + N parse workers + ordered reassembly)
// parses at memory speed.
//
// Output contract: bit-identical batches to the pure-Python reader in
// `openembedding_tpu_torch/data/criteo.py` — same FNV-1a-style fold hash
// (`hash_category`), same log(max(x,0)+4)^2 dense transform, same per-file
// host interleave (row i kept iff i % num_hosts == host_id), verified by
// `tests/test_torch_data.py`.
//
// C ABI (ctypes-friendly, no C++ types across the boundary):
//   oetpu_reader_create(paths, n_paths, batch, id_space, host_id, num_hosts,
//                       n_threads) -> handle
//   oetpu_reader_next(handle, labels[B], dense[B*13], sparse[B*26]) -> rows (0 = EOF)
//   oetpu_reader_destroy(handle)
//   oetpu_hash_category(token, field, id_space) -> folded id
//   oetpu_preprocess(in_path, out_path, min_count, vocab_sizes[26]) -> rows (<0 err)

#ifndef OETPU_NO_ZLIB
#include <zlib.h>
#endif

#include <algorithm>
#include <atomic>
#include <cmath>
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
#include <unordered_map>
#include <vector>

namespace {

// Plain or gzip-transparent input (Criteo-1TB ships day_*.gz; the reference
// streams them through tf.data's GZIP readers, here through zlib directly).
// Built with -DOETPU_NO_ZLIB (hosts without zlib headers) .gz opens fail
// loudly and every plain-file path keeps working.
struct InFile {
  std::FILE* f = nullptr;
#ifndef OETPU_NO_ZLIB
  gzFile gz = nullptr;
#endif

  bool open(const std::string& path) {
    if (path.size() > 3 && path.compare(path.size() - 3, 3, ".gz") == 0) {
#ifndef OETPU_NO_ZLIB
      gz = gzopen(path.c_str(), "rb");
      if (gz) gzbuffer(gz, 1 << 20);  // match kChunkBytes, not zlib's 8 KB
      return gz != nullptr;
#else
      return false;  // no zlib in this build
#endif
    }
    f = std::fopen(path.c_str(), "rb");
    return f != nullptr;
  }

  // >= 0 bytes read; -1 on stream error (caller must treat as hard error)
  long read(char* buf, size_t n) {
#ifndef OETPU_NO_ZLIB
    if (gz) {
      int got = gzread(gz, buf, static_cast<unsigned>(n));
      return got;  // -1 on error
    }
#endif
    size_t got = std::fread(buf, 1, n, f);
    if (got == 0 && std::ferror(f)) return -1;
    return static_cast<long>(got);
  }

  void close() {
#ifndef OETPU_NO_ZLIB
    if (gz) gzclose(gz);
    gz = nullptr;
#endif
    if (f) std::fclose(f);
    f = nullptr;
  }
};

constexpr int kDense = 13;
constexpr int kSparse = 26;
constexpr int kCols = 1 + kDense + kSparse;
constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ull;
constexpr uint64_t kFnvPrime = 0x100000001B3ull;
constexpr uint64_t kSalt = 0x9E3779B97F4A7C15ull;

uint64_t fold_hash(uint64_t token, uint64_t field, uint64_t id_space) {
  uint64_t h = (token ^ kFnvOffset) * kFnvPrime;
  h ^= field + kSalt;
  h *= kFnvPrime;
  h &= 0x7FFFFFFFFFFFFFFFull;
  return h % id_space;
}

// One parsed chunk of rows (struct-of-arrays, ready to memcpy into the batch).
struct RowBlock {
  std::vector<float> labels;
  std::vector<float> dense;    // n * kDense
  std::vector<int64_t> sparse; // n * kSparse
  size_t n = 0;
};

// A raw text chunk: whole lines + the per-file index of its first row.
struct TextChunk {
  uint64_t seq = 0;
  std::string text;          // '\n'-separated complete lines
  uint64_t first_row = 0;    // per-file row index of first line
  bool eof = false;          // sentinel: no more chunks
};

class Reader {
 public:
  Reader(std::vector<std::string> paths, int batch, uint64_t id_space,
         int host_id, int num_hosts, int n_threads)
      : paths_(std::move(paths)), batch_(batch), id_space_(id_space),
        host_id_(host_id), num_hosts_(num_hosts),
        n_threads_(std::max(1, n_threads)) {
    io_thread_ = std::thread([this] { io_loop(); });
    for (int i = 0; i < n_threads_; ++i)
      workers_.emplace_back([this] { parse_loop(); });
  }

  ~Reader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_in_.notify_all();
    cv_out_.notify_all();
    cv_space_.notify_all();
    io_thread_.join();
    for (auto& t : workers_) t.join();
  }

  // Fill caller buffers with up to batch_ rows; 0 = clean EOF, -1 = IO error
  // (the Python reader raises on unreadable files; silently training on a
  // subset would break the bit-identical parity contract).
  int next(float* labels, float* dense, int64_t* sparse) {
    int filled = 0;
    while (filled < batch_) {
      {
        std::lock_guard<std::mutex> lk(mu_);
        if (!error_.empty()) return -1;
      }
      if (cur_ && cur_off_ < cur_->n) {
        size_t take = std::min<size_t>(batch_ - filled, cur_->n - cur_off_);
        std::memcpy(labels + filled, cur_->labels.data() + cur_off_,
                    take * sizeof(float));
        std::memcpy(dense + filled * kDense,
                    cur_->dense.data() + cur_off_ * kDense,
                    take * kDense * sizeof(float));
        std::memcpy(sparse + filled * kSparse,
                    cur_->sparse.data() + cur_off_ * kSparse,
                    take * kSparse * sizeof(int64_t));
        filled += take;
        cur_off_ += take;
        continue;
      }
      // need the next block, in sequence order
      std::unique_lock<std::mutex> lk(mu_);
      cv_out_.wait(lk, [this] {
        return stop_ || !error_.empty() || done_.count(next_seq_) ||
               (io_done_ && inflight_ == 0 && done_.empty());
      });
      if (stop_) return filled;
      if (!error_.empty()) return -1;
      auto it = done_.find(next_seq_);
      if (it == done_.end()) return filled;  // drained: EOF
      cur_ = std::move(it->second);
      done_.erase(it);
      ++next_seq_;
      cur_off_ = 0;
      --inflight_;
      cv_space_.notify_all();
    }
    return filled;
  }

 private:
  static constexpr size_t kChunkBytes = 1 << 20;
  static constexpr size_t kMaxInflight = 64;  // bounds memory (~64 MB of text)

  void set_error(std::string msg) {
    std::lock_guard<std::mutex> lk(mu_);
    if (error_.empty()) error_ = std::move(msg);
    io_done_ = true;
    cv_in_.notify_all();
    cv_out_.notify_all();
  }

  void io_loop() {
    uint64_t seq = 0;
    for (const auto& path : paths_) {
      InFile in;
      if (!in.open(path)) {  // unreadable file is an ERROR, like Python open()
        set_error("cannot open " + path);
        return;
      }
      uint64_t row = 0;
      std::string carry;  // only the short unterminated tail of each read
      std::vector<char> buf(kChunkBytes);
      while (true) {
        long got = in.read(buf.data(), buf.size());
        if (got < 0) {
          in.close();
          set_error("read error on " + path);
          return;
        }
        if (got == 0) break;
        const char* nl = static_cast<const char*>(
            memrchr(buf.data(), '\n', static_cast<size_t>(got)));
        if (!nl) {  // no newline in the whole read: accumulate and continue
          carry.append(buf.data(), static_cast<size_t>(got));
          continue;
        }
        size_t head = static_cast<size_t>(nl - buf.data()) + 1;
        TextChunk chunk;
        chunk.text.reserve(carry.size() + head);
        chunk.text = std::move(carry);
        chunk.text.append(buf.data(), head);
        carry.assign(buf.data() + head, static_cast<size_t>(got) - head);
        chunk.first_row = row;
        row += static_cast<uint64_t>(
            std::count(chunk.text.begin(), chunk.text.end(), '\n'));
        chunk.seq = seq++;
        if (!push_chunk(std::move(chunk))) { in.close(); return; }
      }
      in.close();
      if (!carry.empty()) {  // final unterminated line
        TextChunk chunk;
        chunk.text = std::move(carry);
        chunk.text.push_back('\n');
        chunk.first_row = row;
        chunk.seq = seq++;
        if (!push_chunk(std::move(chunk))) return;
      }
    }
    std::lock_guard<std::mutex> lk(mu_);
    io_done_ = true;
    cv_in_.notify_all();
    cv_out_.notify_all();
  }

  bool push_chunk(TextChunk&& chunk) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_space_.wait(lk, [this] { return stop_ || inflight_ < kMaxInflight; });
    if (stop_) return false;
    ++inflight_;
    pending_.push_back(std::move(chunk));
    cv_in_.notify_one();
    return true;
  }

  void parse_loop() {
    while (true) {
      TextChunk chunk;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_in_.wait(lk, [this] { return stop_ || !pending_.empty() || io_done_; });
        if (stop_) return;
        if (pending_.empty()) {
          if (io_done_) return;
          continue;
        }
        chunk = std::move(pending_.front());
        pending_.pop_front();
      }
      auto block = std::make_unique<RowBlock>();
      parse_chunk(chunk, *block);
      {
        // inflight_ stays held until the consumer pops the block (next()), so
        // kMaxInflight bounds text chunks AND parsed-but-unconsumed blocks
        std::lock_guard<std::mutex> lk(mu_);
        done_.emplace(chunk.seq, std::move(block));
        cv_out_.notify_all();
      }
    }
  }

  void parse_chunk(const TextChunk& chunk, RowBlock& out) {
    const char* p = chunk.text.data();
    const char* end = p + chunk.text.size();
    uint64_t row = chunk.first_row;
    out.labels.reserve(1024);
    while (p < end) {
      const char* nl = static_cast<const char*>(
          std::memchr(p, '\n', static_cast<size_t>(end - p)));
      if (!nl) nl = end;
      if (num_hosts_ <= 1 ||
          static_cast<int64_t>(row % static_cast<uint64_t>(num_hosts_)) ==
              host_id_) {
        parse_line(p, nl, out);
      }
      ++row;
      p = nl + 1;
    }
    out.n = out.labels.size();
  }

  static const char* next_field(const char* p, const char* end) {
    const char* tab = static_cast<const char*>(
        std::memchr(p, '\t', static_cast<size_t>(end - p)));
    return tab ? tab : end;
  }

  void parse_line(const char* p, const char* end, RowBlock& out) {
    // label
    const char* f_end = next_field(p, end);
    out.labels.push_back(f_end > p ? std::strtof(p, nullptr) : 0.0f);
    p = f_end < end ? f_end + 1 : end;
    // dense: (log(max(x,0)+4))^2 in double, like numpy does (data/criteo.py)
    for (int i = 0; i < kDense; ++i) {
      double x = 0.0;
      if (p < end) {
        f_end = next_field(p, end);
        if (f_end > p) x = std::strtod(p, nullptr);
        p = f_end < end ? f_end + 1 : end;
      }
      double lg = std::log(std::max(x, 0.0) + 4.0);
      out.dense.push_back(static_cast<float>(lg * lg));
    }
    // categorical: hex token (or field index when empty/missing), fold-hashed
    for (int i = 0; i < kSparse; ++i) {
      uint64_t tok = static_cast<uint64_t>(i);
      if (p < end) {
        f_end = next_field(p, end);
        if (f_end > p) tok = std::strtoull(p, nullptr, 16);
        p = f_end < end ? f_end + 1 : end;
      }
      out.sparse.push_back(static_cast<int64_t>(
          fold_hash(tok, static_cast<uint64_t>(i), id_space_)));
    }
  }

  std::vector<std::string> paths_;
  const int batch_;
  const uint64_t id_space_;
  const int host_id_;
  const int num_hosts_;
  const int n_threads_;

  std::mutex mu_;
  std::condition_variable cv_in_, cv_out_, cv_space_;
  std::deque<TextChunk> pending_;
  std::map<uint64_t, std::unique_ptr<RowBlock>> done_;
  uint64_t next_seq_ = 0;
  size_t inflight_ = 0;
  bool io_done_ = false;
  bool stop_ = false;
  std::string error_;

  std::unique_ptr<RowBlock> cur_;
  size_t cur_off_ = 0;

  std::thread io_thread_;
  std::vector<std::thread> workers_;
};

// ---------------------------------------------------------------------------
// TFRecord reader: the reference's benchmark format (`test/benchmark/
// criteo_tfrecord.py` — tf.train.Example with label int64[1], I1..I13
// float[1], C1..C26 int64[1]) WITHOUT a TensorFlow dependency: hand-rolled
// record framing (uint64 length + masked CRC32C of length and payload) and a
// proto-wire walker for exactly this schema. Files read SEQUENTIALLY in the
// given order (the deterministic cycle_length=1 order the Python reader
// pins — an autotuned interleave width would make the data order
// machine-dependent), record-level host sharding
// (global index % num_hosts == host_id).
// ---------------------------------------------------------------------------

const uint32_t* crc32c_table() {
  static uint32_t table[256];
  static bool init = [] {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;  // Castagnoli, reflected
      table[i] = c;
    }
    return true;
  }();
  (void)init;
  return table;
}

uint32_t crc32c(const uint8_t* p, size_t n) {
  const uint32_t* t = crc32c_table();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) c = t[(c ^ p[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

uint32_t masked_crc32c(const uint8_t* p, size_t n) {
  uint32_t c = crc32c(p, n);
  return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Read a (tag, payload-range-or-scalar); only the wire types the Example
// schema uses. Returns false on malformed input.
bool skip_field(const uint8_t*& p, const uint8_t* end, uint32_t wire) {
  uint64_t v;
  switch (wire) {
    case 0: return read_varint(p, end, &v);
    case 1: if (end - p < 8) return false; p += 8; return true;
    case 2:
      if (!read_varint(p, end, &v) || static_cast<uint64_t>(end - p) < v)
        return false;
      p += v;
      return true;
    case 5: if (end - p < 4) return false; p += 4; return true;
    default: return false;
  }
}

// First value of a Feature message: float_list (field 2) or int64_list
// (field 3), packed or not. kind_out: 2 = float, 3 = int64.
bool parse_feature(const uint8_t* p, const uint8_t* end, int* kind_out,
                   double* fval, int64_t* ival) {
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    uint32_t field = static_cast<uint32_t>(tag >> 3);
    uint32_t wire = static_cast<uint32_t>(tag & 7);
    if ((field == 2 || field == 3) && wire == 2) {
      uint64_t len;
      if (!read_varint(p, end, &len) ||
          static_cast<uint64_t>(end - p) < len)
        return false;
      const uint8_t* q = p;
      const uint8_t* qend = p + len;
      while (q < qend) {  // the inner list message
        uint64_t t2;
        if (!read_varint(q, qend, &t2)) return false;
        uint32_t f2 = static_cast<uint32_t>(t2 >> 3);
        uint32_t w2 = static_cast<uint32_t>(t2 & 7);
        if (f2 == 1 && field == 2 && w2 == 2) {  // packed floats
          uint64_t blen;
          if (!read_varint(q, qend, &blen) || blen < 4 ||
              static_cast<uint64_t>(qend - q) < blen)
            return false;
          float f;
          std::memcpy(&f, q, 4);
          *kind_out = 2;
          *fval = f;
          return true;
        }
        if (f2 == 1 && field == 2 && w2 == 5) {  // unpacked float
          if (qend - q < 4) return false;
          float f;
          std::memcpy(&f, q, 4);
          *kind_out = 2;
          *fval = f;
          return true;
        }
        if (f2 == 1 && field == 3 && w2 == 2) {  // packed varints
          uint64_t blen;
          if (!read_varint(q, qend, &blen) ||
              static_cast<uint64_t>(qend - q) < blen)
            return false;
          const uint8_t* r = q;
          uint64_t v;
          if (!read_varint(r, q + blen, &v)) return false;
          *kind_out = 3;
          *ival = static_cast<int64_t>(v);
          return true;
        }
        if (f2 == 1 && field == 3 && w2 == 0) {  // unpacked varint
          uint64_t v;
          if (!read_varint(q, qend, &v)) return false;
          *kind_out = 3;
          *ival = static_cast<int64_t>(v);
          return true;
        }
        if (!skip_field(q, qend, w2)) return false;
      }
      p = qend;
    } else if (!skip_field(p, end, wire)) {
      return false;
    }
  }
  return false;
}

// "label" -> (0, 0); "I<k>" -> (1, k-1); "C<k>" -> (2, k-1); else (-1, _).
void classify_key(const uint8_t* k, size_t n, int* kind, int* idx) {
  *kind = -1;
  if (n == 5 && std::memcmp(k, "label", 5) == 0) {
    *kind = 0;
    *idx = 0;
  } else if (n >= 2 && n <= 3 && (k[0] == 'I' || k[0] == 'C')) {
    // suffix capped at 2 digits (valid range 1..26): an attacker-length
    // digit string must not overflow the accumulator into a valid index
    int v = 0;
    for (size_t i = 1; i < n; ++i) {
      if (k[i] < '0' || k[i] > '9') return;
      v = v * 10 + (k[i] - '0');
    }
    if (k[0] == 'I' && v >= 1 && v <= kDense) {
      *kind = 1;
      *idx = v - 1;
    } else if (k[0] == 'C' && v >= 1 && v <= kSparse) {
      *kind = 2;
      *idx = v - 1;
    }
  }
}

// One serialized tf.train.Example -> row columns. STRICT on the schema: a
// missing key fails the parse, matching the tf path's FixedLenFeature error
// — silently zero-filling would train on fabricated data with no signal.
bool parse_example(const uint8_t* p, const uint8_t* end, float* label,
                   float* dense, int64_t* sparse) {
  uint64_t seen = 0;  // bit 0 = label, 1..13 = I, 14..39 = C
  *label = 0.0f;
  std::memset(dense, 0, sizeof(float) * kDense);
  std::memset(sparse, 0, sizeof(int64_t) * kSparse);
  while (p < end) {
    uint64_t tag;
    if (!read_varint(p, end, &tag)) return false;
    if ((tag >> 3) == 1 && (tag & 7) == 2) {  // Example.features
      uint64_t flen;
      if (!read_varint(p, end, &flen) ||
          static_cast<uint64_t>(end - p) < flen)
        return false;
      const uint8_t* fp = p;
      const uint8_t* fend = p + flen;
      while (fp < fend) {  // Features.feature map entries
        uint64_t t2;
        if (!read_varint(fp, fend, &t2)) return false;
        if ((t2 >> 3) == 1 && (t2 & 7) == 2) {
          uint64_t elen;
          if (!read_varint(fp, fend, &elen) ||
              static_cast<uint64_t>(fend - fp) < elen)
            return false;
          const uint8_t* ep = fp;
          const uint8_t* eend = fp + elen;
          const uint8_t* key = nullptr;
          size_t key_len = 0;
          const uint8_t* val = nullptr;
          size_t val_len = 0;
          while (ep < eend) {  // map entry: key=1 string, value=2 Feature
            uint64_t t3;
            if (!read_varint(ep, eend, &t3)) return false;
            uint64_t l3;
            if ((t3 & 7) != 2 || !read_varint(ep, eend, &l3) ||
                static_cast<uint64_t>(eend - ep) < l3)
              return false;
            if ((t3 >> 3) == 1) {
              key = ep;
              key_len = l3;
            } else if ((t3 >> 3) == 2) {
              val = ep;
              val_len = l3;
            }
            ep += l3;
          }
          if (key && val) {
            int kind, idx;
            classify_key(key, key_len, &kind, &idx);
            if (kind >= 0) {
              int vkind;
              double fv = 0.0;
              int64_t iv = 0;
              if (parse_feature(val, val + val_len, &vkind, &fv, &iv)) {
                if (kind == 0) {
                  *label = vkind == 3 ? static_cast<float>(iv)
                                      : static_cast<float>(fv);
                  seen |= 1ull;
                } else if (kind == 1) {
                  dense[idx] = vkind == 3 ? static_cast<float>(iv)
                                          : static_cast<float>(fv);
                  seen |= 1ull << (1 + idx);
                } else {
                  sparse[idx] = vkind == 3 ? iv : static_cast<int64_t>(fv);
                  seen |= 1ull << (1 + kDense + idx);
                }
              }
            }
          }
          fp += elen;
        } else if (!skip_field(fp, fend, static_cast<uint32_t>(t2 & 7))) {
          return false;
        }
      }
      p = fend;
    } else if (!skip_field(p, end, static_cast<uint32_t>(tag & 7))) {
      return false;
    }
  }
  const uint64_t all = (1ull << (1 + kDense + kSparse)) - 1;
  return seen == all;
}

// A chunk of serialized records handed to parse workers.
struct TfrChunk {
  uint64_t seq = 0;
  std::vector<std::string> records;
};

// NOTE: TfrReader shares the IO-thread + parse-workers + seq-ordered-merge
// SHAPE with the TSV Reader above but not its internals: chunk units differ
// (framed records vs split text), as does the inflight accounting (the TSV
// pipeline debits on consume, this one on parse). The two are deliberately
// separate, each with its own shutdown/error tests — a shared template over
// those differences would couple two proven concurrency paths for ~100
// saved lines.
class TfrReader {
 public:
  TfrReader(std::vector<std::string> paths, int batch, int host_id,
            int num_hosts, int n_threads)
      : paths_(std::move(paths)), batch_(batch), host_id_(host_id),
        num_hosts_(num_hosts), n_threads_(std::max(1, n_threads)) {
    io_thread_ = std::thread([this] { io_loop(); });
    for (int i = 0; i < n_threads_; ++i)
      workers_.emplace_back([this] { parse_loop(); });
  }

  ~TfrReader() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_in_.notify_all();
    cv_out_.notify_all();
    cv_space_.notify_all();
    io_thread_.join();
    for (auto& t : workers_) t.join();
  }

  int next(float* labels, float* dense, int64_t* sparse) {
    int filled = 0;
    while (filled < batch_) {
      if (!cur_ || cur_off_ >= cur_->n) {
        std::unique_lock<std::mutex> lk(mu_);
        cv_out_.wait(lk, [this] {
          return stop_ || !error_.empty() || done_.count(next_out_) ||
                 (io_done_ && inflight_ == 0 && pending_.empty());
        });
        if (!error_.empty()) return -1;
        auto it = done_.find(next_out_);
        if (it == done_.end()) break;  // clean EOF
        cur_ = std::move(it->second);
        done_.erase(it);
        ++next_out_;
        cur_off_ = 0;
        cv_space_.notify_all();
        continue;
      }
      size_t take = std::min<size_t>(cur_->n - cur_off_,
                                     static_cast<size_t>(batch_ - filled));
      std::memcpy(labels + filled, cur_->labels.data() + cur_off_,
                  take * sizeof(float));
      std::memcpy(dense + static_cast<size_t>(filled) * kDense,
                  cur_->dense.data() + cur_off_ * kDense,
                  take * kDense * sizeof(float));
      std::memcpy(sparse + static_cast<size_t>(filled) * kSparse,
                  cur_->sparse.data() + cur_off_ * kSparse,
                  take * kSparse * sizeof(int64_t));
      filled += static_cast<int>(take);
      cur_off_ += take;
    }
    return filled;
  }

 private:
  static constexpr size_t kChunkRecords = 512;
  static constexpr size_t kMaxPending = 64;

  // Read ONE framed record from f into out; 1 = ok, 0 = clean EOF, -1 = bad.
  int read_record(std::FILE* f, std::string* out) {
    uint8_t hdr[12];
    size_t got = std::fread(hdr, 1, 12, f);
    if (got == 0) return 0;
    if (got != 12) return -1;
    uint64_t len;
    std::memcpy(&len, hdr, 8);  // little-endian hosts only (x86/ARM)
    uint32_t len_crc;
    std::memcpy(&len_crc, hdr + 8, 4);
    if (masked_crc32c(hdr, 8) != len_crc) return -1;
    if (len > (1ull << 30)) return -1;  // sanity: 1 GiB record
    out->resize(len);
    if (std::fread(out->data(), 1, len, f) != len) return -1;
    uint8_t crc_buf[4];
    if (std::fread(crc_buf, 1, 4, f) != 4) return -1;
    uint32_t data_crc;
    std::memcpy(&data_crc, crc_buf, 4);
    if (masked_crc32c(reinterpret_cast<const uint8_t*>(out->data()), len) !=
        data_crc)
      return -1;
    return 1;
  }

  void io_loop() {
    std::vector<std::FILE*> files;
    for (const auto& p : paths_) {
      std::FILE* f = std::fopen(p.c_str(), "rb");
      if (!f) {
        fail("cannot open " + p);
        for (auto* g : files) std::fclose(g);
        return;
      }
      files.push_back(f);
    }
    uint64_t global_idx = 0;
    uint64_t seq = 0;
    TfrChunk chunk;
    std::string rec;
    bool aborted = false;
    for (size_t at = 0; at < files.size() && !aborted; ++at) {
      while (true) {
        {
          std::lock_guard<std::mutex> lk(mu_);
          if (stop_) {
            aborted = true;
            break;
          }
        }
        int r = read_record(files[at], &rec);
        if (r < 0) {
          fail("corrupt TFRecord in " + paths_[at]);
          aborted = true;
          break;
        }
        if (r == 0) break;  // next file
        if (global_idx++ % static_cast<uint64_t>(num_hosts_) ==
            static_cast<uint64_t>(host_id_))
          chunk.records.push_back(std::move(rec));
        if (chunk.records.size() >= kChunkRecords)
          emit(&chunk, &seq);
      }
    }
    if (!chunk.records.empty()) emit(&chunk, &seq);
    std::lock_guard<std::mutex> lk(mu_);
    io_done_ = true;
    cv_in_.notify_all();
    cv_out_.notify_all();
    for (auto* f : files) std::fclose(f);
  }

  void emit(TfrChunk* chunk, uint64_t* seq) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_space_.wait(lk, [this] {
      return stop_ || pending_.size() + done_.size() < kMaxPending;
    });
    if (stop_) return;
    chunk->seq = (*seq)++;
    pending_.push_back(std::move(*chunk));
    *chunk = TfrChunk();
    cv_in_.notify_one();
  }

  void parse_loop() {
    while (true) {
      TfrChunk chunk;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_in_.wait(lk, [this] {
          return stop_ || !pending_.empty() || io_done_;
        });
        if (stop_) return;
        if (pending_.empty()) {
          if (io_done_) return;
          continue;
        }
        chunk = std::move(pending_.front());
        pending_.pop_front();
        ++inflight_;
      }
      auto block = std::make_unique<RowBlock>();
      block->n = chunk.records.size();
      block->labels.resize(block->n);
      block->dense.resize(block->n * kDense);
      block->sparse.resize(block->n * kSparse);
      bool ok = true;
      for (size_t i = 0; i < chunk.records.size(); ++i) {
        const auto& r = chunk.records[i];
        const uint8_t* p = reinterpret_cast<const uint8_t*>(r.data());
        if (!parse_example(p, p + r.size(), &block->labels[i],
                           &block->dense[i * kDense],
                           &block->sparse[i * kSparse])) {
          ok = false;
          break;
        }
      }
      std::lock_guard<std::mutex> lk(mu_);
      --inflight_;
      if (!ok) {
        error_ = "malformed tf.train.Example (bad wire data or missing schema key)";
      } else {
        done_[chunk.seq] = std::move(block);
      }
      cv_out_.notify_all();
    }
  }

  void fail(std::string msg) {
    std::lock_guard<std::mutex> lk(mu_);
    error_ = std::move(msg);
    io_done_ = true;
    cv_out_.notify_all();
    cv_in_.notify_all();
  }

  const std::vector<std::string> paths_;
  const int batch_;
  const int host_id_;
  const int num_hosts_;
  const int n_threads_;

  std::mutex mu_;
  std::condition_variable cv_in_, cv_out_, cv_space_;
  std::deque<TfrChunk> pending_;
  std::map<uint64_t, std::unique_ptr<RowBlock>> done_;
  uint64_t next_out_ = 0;
  size_t inflight_ = 0;
  bool io_done_ = false;
  bool stop_ = false;
  std::string error_;

  std::unique_ptr<RowBlock> cur_;
  size_t cur_off_ = 0;

  std::thread io_thread_;
  std::vector<std::thread> workers_;
};

}  // namespace

extern "C" {

void* oetpu_tfr_create(const char** paths, int n_paths, int batch, int host_id,
                       int num_hosts, int n_threads) {
  std::vector<std::string> ps(paths, paths + n_paths);
  return new TfrReader(std::move(ps), batch, host_id, num_hosts, n_threads);
}

int oetpu_tfr_next(void* handle, float* labels, float* dense,
                   int64_t* sparse) {
  return static_cast<TfrReader*>(handle)->next(labels, dense, sparse);
}

void oetpu_tfr_destroy(void* handle) {
  delete static_cast<TfrReader*>(handle);
}

}  // extern "C"

extern "C" {

void* oetpu_reader_create(const char** paths, int n_paths, int batch,
                          uint64_t id_space, int host_id, int num_hosts,
                          int n_threads) {
  std::vector<std::string> ps(paths, paths + n_paths);
  return new Reader(std::move(ps), batch, id_space, host_id, num_hosts,
                    n_threads);
}

int oetpu_reader_next(void* handle, float* labels, float* dense,
                      int64_t* sparse) {
  return static_cast<Reader*>(handle)->next(labels, dense, sparse);
}

void oetpu_reader_destroy(void* handle) { delete static_cast<Reader*>(handle); }

int64_t oetpu_hash_category(uint64_t token, uint64_t field, uint64_t id_space) {
  return static_cast<int64_t>(fold_hash(token, field, id_space));
}

// Frequency relabel (reference `test/criteo_preprocess.cpp`): tokens of each
// categorical column are renumbered 1..V_c by descending frequency (count >=
// min_count), 0 otherwise; dense/labels pass through untouched. Writes TSV;
// vocab_sizes[kSparse] receives V_c + 1 per column (id 0 reserved for rare).
int64_t oetpu_preprocess(const char* in_path, const char* out_path,
                         int min_count, int64_t* vocab_sizes) {
  std::FILE* in = std::fopen(in_path, "rb");
  if (!in) return -1;
  std::vector<std::unordered_map<uint64_t, int64_t>> counts(kSparse);
  std::string line;
  char buf[1 << 16];
  auto for_each_line = [&](std::FILE* f, auto&& fn) {
    std::string carry;
    while (size_t got = std::fread(buf, 1, sizeof(buf), f)) {
      carry.append(buf, got);
      size_t pos = 0, nl;
      while ((nl = carry.find('\n', pos)) != std::string::npos) {
        fn(carry.data() + pos, carry.data() + nl);
        pos = nl + 1;
      }
      carry.erase(0, pos);
    }
    if (!carry.empty()) fn(carry.data(), carry.data() + carry.size());
  };

  int64_t rows = 0;
  for_each_line(in, [&](const char* p, const char* end) {
    ++rows;
    int col = 0;
    while (p <= end && col < kCols) {
      const char* tab = static_cast<const char*>(
          std::memchr(p, '\t', static_cast<size_t>(end - p)));
      const char* f_end = tab ? tab : end;
      int cat = col - 1 - kDense;
      if (cat >= 0 && cat < kSparse && f_end > p)
        ++counts[cat][std::strtoull(p, nullptr, 16)];
      ++col;
      if (!tab) break;
      p = tab + 1;
    }
  });
  std::fclose(in);

  // rank by (count desc, token asc) for determinism
  std::vector<std::unordered_map<uint64_t, int64_t>> remap(kSparse);
  for (int c = 0; c < kSparse; ++c) {
    std::vector<std::pair<uint64_t, int64_t>> items(counts[c].begin(),
                                                    counts[c].end());
    std::sort(items.begin(), items.end(), [](const auto& a, const auto& b) {
      return a.second != b.second ? a.second > b.second : a.first < b.first;
    });
    int64_t next_id = 1;
    for (const auto& [tok, cnt] : items)
      if (cnt >= min_count) remap[c][tok] = next_id++;
    if (vocab_sizes) vocab_sizes[c] = next_id;  // ids 0..next_id-1
  }

  in = std::fopen(in_path, "rb");
  std::FILE* out = std::fopen(out_path, "wb");
  if (!in || !out) {
    if (in) std::fclose(in);
    if (out) std::fclose(out);
    return -2;
  }
  for_each_line(in, [&](const char* p, const char* end) {
    std::string o;
    o.reserve(static_cast<size_t>(end - p) + 16);
    int col = 0;
    const char* q = p;
    while (q <= end && col < kCols) {
      const char* tab = static_cast<const char*>(
          std::memchr(q, '\t', static_cast<size_t>(end - q)));
      const char* f_end = tab ? tab : end;
      if (col > 0) o.push_back('\t');
      int cat = col - 1 - kDense;
      if (cat >= 0 && cat < kSparse) {
        int64_t id = 0;
        if (f_end > q) {
          auto it = remap[cat].find(std::strtoull(q, nullptr, 16));
          if (it != remap[cat].end()) id = it->second;
        }
        o += std::to_string(id);
      } else {
        o.append(q, f_end);
      }
      ++col;
      if (!tab) break;
      q = tab + 1;
    }
    while (col < kCols) {  // pad short rows like the readers do
      if (col > 0) o.push_back('\t');
      if (col - 1 - kDense >= 0) o.push_back('0');
      ++col;
    }
    o.push_back('\n');
    std::fwrite(o.data(), 1, o.size(), out);
  });
  std::fclose(in);
  std::fclose(out);
  return rows;
}

}  // extern "C"
