// Native corpus ingest: file -> NUL-padded fixed-width line rows.
//
// The PyTorch port's own copy of the JAX package's native/ingest.cpp (the
// same five C entry points, byte for byte the same output).  Host code:
// locust_tpu_torch/_build.py compiles it with g++ into a shared library
// with a plain C interface, loaded with ctypes by io/native_ingest.py.
//
// The host ingest of the reference (loadFile, reference
// MapReduce/src/main.cu:40-64) reads with a getline loop into 204-byte
// structs; here the batch entries (ingest_count_lines, ingest_load_rows)
// stream the file through one reused kChunk buffer (ChunkReader), find
// line ends with memchr, and pad rows straight into the caller's
// contiguous [max_lines, width] uint8 buffer (each output byte written
// once: the row's bytes, then its tail zeroed), which the Python side
// hands to torch.from_numpy with no further copy.  Honors the same
// [line_start, line_end) node-shard slice (main.cu:47-54) and fixes the
// reference's dropped-final-line off-by-one (SURVEY.md Q1).

#include <fcntl.h>
#include <unistd.h>

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// The batch entries' read buffer: a line longer than this keeps its first
// `width` bytes while the rest streams past, as in ingest_load_window.
constexpr long kChunk = 4L << 20;

// One pass over a file in kChunk pieces through one reused buffer.
class ChunkReader {
 public:
  explicit ChunkReader(const char* path)
      : fd_(::open(path, O_RDONLY | O_CLOEXEC)),
        buf_(fd_ >= 0 ? static_cast<char*>(std::malloc(kChunk)) : nullptr) {}
  ChunkReader(const ChunkReader&) = delete;
  ChunkReader& operator=(const ChunkReader&) = delete;
  ~ChunkReader() {
    std::free(buf_);
    if (fd_ >= 0) ::close(fd_);
  }
  bool ok() const { return buf_ != nullptr; }
  const char* data() const { return buf_; }
  // Reads the next piece into data(): its bytes, 0 at EOF, -1 on an I/O
  // error (EINTR retried).
  long next() {
    for (;;) {
      const long got = static_cast<long>(::read(fd_, buf_, kChunk));
      if (got >= 0 || errno != EINTR) return got;
    }
  }

 private:
  const int fd_;
  char* const buf_;
};

}  // namespace

extern "C" {

// Number of lines in the file ('\n'-separated; a trailing fragment without
// a newline counts — the Q1 fix).  Returns -1 on I/O error.
long ingest_count_lines(const char* path) {
  ChunkReader in(path);
  if (!in.ok()) return -1;
  long lines = 0, got;
  char last = '\n';
  while ((got = in.next()) > 0) {
    const char* p = in.data();
    const char* const e = p + got;
    while ((p = static_cast<const char*>(std::memchr(p, '\n', e - p)))) {
      ++lines;
      ++p;
    }
    last = e[-1];
  }
  if (got < 0) return -1;
  return last == '\n' ? lines : lines + 1;
}

// Load lines [line_start, line_end) into out[max_lines][width], NUL-padded,
// '\r' stripped at line end, content truncated to width.  Negative
// start/end mean "whole file" (reference CLI default, main.cu:369-374).
// Every returned row is written whole (its bytes, then its zeroed tail), so
// `out` needs no zeroing; rows past the return value are left untouched.
// Returns rows written, or -1 on I/O error.
long ingest_load_rows(const char* path, unsigned char* out, long max_lines,
                      long width, long line_start, long line_end) {
  ChunkReader in(path);
  if (!in.ok()) return -1;
  const long start = line_start < 0 ? 0 : line_start;
  const long end = line_end;  // < 0 = unbounded
  long line = 0, row = 0;
  long len = 0;  // bytes seen of the line in progress
  auto wanted = [&]() { return line >= start && (end < 0 || line < end); };
  auto stop = [&]() { return row >= max_lines || (end >= 0 && line >= end); };
  // Close the line in progress: strip a CRLF '\r' only when it is the
  // line's last byte (at a truncated position it is data), zero the tail.
  auto close_line = [&]() {
    if (wanted()) {
      unsigned char* r = out + row * width;
      long keep = len < width ? len : width;
      if (len <= width && len > 0 && r[len - 1] == '\r') --keep;
      std::memset(r + keep, 0, static_cast<size_t>(width - keep));
      ++row;
    }
    ++line;
    len = 0;
  };

  bool done = stop();
  long got = 0;
  while (!done && (got = in.next()) > 0) {
    const char* p = in.data();
    const char* const e = p + got;
    while (p < e) {
      const char* nl = static_cast<const char*>(std::memchr(p, '\n', e - p));
      const long n = (nl ? nl : e) - p;
      if (len < width && wanted()) {
        const long take = n < width - len ? n : width - len;
        std::memcpy(out + row * width + len, p, static_cast<size_t>(take));
      }
      len += n;
      if (!nl) break;  // the line goes on in the next piece
      close_line();
      if ((done = stop())) break;
      p = nl + 1;
    }
  }
  if (got < 0) return -1;
  if (!done && len > 0) close_line();  // trailing fragment (Q1)
  return row;
}

// Streaming window scan: resume at byte *inout_offset / line *inout_line,
// fill out[max_lines][width] (NUL-padded, '\r' stripped, truncated to
// width), honoring the [line_start, line_end) slice.  Advances the two
// cursors to the exact resume point (always a line boundary) and returns
// rows written — 0 means EOF or slice end.  Unlike ingest_load_rows, the
// file is NEVER materialized: one fixed 1MB read buffer regardless of
// file or line length (a line longer than the buffer keeps only its first
// `width` bytes while the remainder streams past), which is what lets the
// 1GB+ north-star corpus (BASELINE.json) run in bounded RSS.
long ingest_load_window(const char* path, long* inout_offset,
                        long* inout_line, unsigned char* out, long max_lines,
                        long width, long line_start, long line_end) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (std::fseek(f, *inout_offset, SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  const long start = line_start < 0 ? 0 : line_start;
  const long end = line_end;  // < 0 = unbounded
  long line = *inout_line;
  long row = 0;
  long consumed = 0;  // bytes folded into COMPLETED (or EOF-final) lines
  long linelen = 0;   // bytes seen of the in-progress line
  std::memset(out, 0, static_cast<size_t>(max_lines) * width);

  const long B = 1 << 20;
  unsigned char* buf = static_cast<unsigned char*>(std::malloc(B));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  bool done = false;
  bool in_line = false;
  while (!done) {
    long got = static_cast<long>(std::fread(buf, 1, B, f));
    if (got <= 0) break;  // EOF
    for (long i = 0; i < got; ++i) {
      const bool want = line >= start && (end < 0 || line < end);
      if (end >= 0 && line >= end) {
        done = true;
        break;
      }
      if (!in_line && want && row >= max_lines) {
        done = true;  // capacity reached at a line boundary: resume here
        break;
      }
      const unsigned char c = buf[i];
      ++consumed;
      if (c == '\n') {
        if (want) {
          long len = linelen < width ? linelen : width;
          // Strip the CRLF '\r' only when it actually is the line's last
          // byte; at a truncated position (linelen > width) it is data.
          if (linelen <= width && len > 0 &&
              out[row * width + len - 1] == '\r')
            out[row * width + len - 1] = 0;
          ++row;
        }
        ++line;
        linelen = 0;
        in_line = false;
      } else {
        in_line = true;
        if (want && linelen < width) out[row * width + linelen] = c;
        ++linelen;
      }
    }
  }
  if (in_line && !done) {  // trailing fragment without '\n' (Q1 fix)
    const bool want = line >= start && (end < 0 || line < end);
    if (want && row < max_lines) {
      long len = linelen < width ? linelen : width;
      if (linelen <= width && len > 0 && out[row * width + len - 1] == '\r')
        out[row * width + len - 1] = 0;
      ++row;
    }
    ++line;
  }
  std::free(buf);
  std::fclose(f);
  *inout_offset += consumed;
  *inout_line = line;
  return row;
}

// Single-pass streaming caps measure: max token bytes + max tokens/line
// over the WIDTH-TRUNCATED view of each line in [line_start, line_end) —
// the same measurement io/loader.measure_caps_rows makes over staged row
// blocks (a token is a maximal run of non-delimiter bytes within the
// first `width` bytes; bytes past the truncation point are invisible, so
// a run caps there and later tokens on the line don't exist).  The
// delimiter set is PASSED IN (config.FULL_DELIMITERS) — a hardcoded copy
// here would drift from the device tokenizer and let --auto-caps
// under-size emits_per_line.  '\r' needs no special case: the windowed
// loader strips a trailing CR, but CR is in the delimiter set so a
// stripped-vs-kept CR closes the same token either way.  Floors are
// (1, 1) like the Python sites.  Returns 0, or -1 on I/O error.
long ingest_measure_caps(const char* path, long width, long line_start,
                         long line_end, const unsigned char* delims,
                         long n_delims, long* out_max_tok,
                         long* out_max_per_line) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  bool lut[256] = {false};
  for (long i = 0; i < n_delims; ++i) lut[delims[i]] = true;
  lut[static_cast<unsigned char>('\n')] = true;  // line terminator anyway

  const long B = 1 << 20;
  unsigned char* buf = static_cast<unsigned char*>(std::malloc(B));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  const long start = line_start < 0 ? 0 : line_start;
  const long end = line_end;  // < 0 = unbounded
  long line = 0, pos = 0, run = 0, toks = 0;
  long max_tok = 1, max_per_line = 1;
  bool in_line = false;
  bool done = false;

  // Close the current token run / line, folding into the maxima.
  auto close_run = [&]() {
    if (run > max_tok) max_tok = run;
    run = 0;
  };
  auto close_line = [&]() {
    close_run();
    if (toks > max_per_line) max_per_line = toks;
    ++line;
    pos = 0;
    toks = 0;
    in_line = false;
  };

  while (!done) {
    long got = static_cast<long>(std::fread(buf, 1, B, f));
    if (got <= 0) {
      // A mid-file read ERROR must not return caps measured from a
      // prefix — silently undersized caps would drop real emits.
      if (std::ferror(f)) {
        std::free(buf);
        std::fclose(f);
        return -1;
      }
      break;  // clean EOF
    }
    for (long i = 0; i < got; ++i) {
      if (end >= 0 && line >= end) {
        done = true;
        break;
      }
      const unsigned char c = buf[i];
      if (c == '\n') {
        close_line();
        continue;
      }
      in_line = true;
      const bool want = line >= start;
      if (want && pos < width) {
        if (lut[c]) {
          close_run();
        } else {
          if (run == 0) ++toks;
          ++run;
        }
      }
      ++pos;
    }
  }
  if (in_line && !done) close_line();  // trailing fragment (Q1 semantics)
  std::free(buf);
  std::fclose(f);
  *out_max_tok = max_tok;
  *out_max_per_line = max_per_line;
  return 0;
}

// Streaming "key\tvalue" TSV parser — the native fast path for the
// reduce stage's intermediate loads (python analog: io/serde.read_tsv;
// reference analog: loadIntermediateFile, main.cu:66-103).  Semantics
// must match serde.read_tsv EXACTLY (parity-tested):
//   * split each line at the FIRST tab,
//   * strip trailing ' ' from the key (the reference writes "key \t", Q5)
//     — at the key's true end only, not at the width-truncation point,
//   * keys NUL-pad / truncate to key_width,
//   * values parse as base-10 ints with surrounding whitespace tolerated
//     (python int()); malformed values and empty keys skip the row,
//   * blank lines skip; '\r' before '\n' is stripped.
// Bounded memory: one fixed 1MB read buffer; per-line state carries only
// the first key_width key bytes and a small value buffer.
// Call with out_keys == NULL to COUNT parseable rows (pass 1), then with
// buffers sized [count, key_width] / [count] to fill (pass 2).
// Returns rows parsed/filled, or -1 on I/O error.
long ingest_read_tsv(const char* path, unsigned char* out_keys,
                     int* out_values, long max_rows, long key_width) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const long B = 1 << 20;
  unsigned char* buf = static_cast<unsigned char*>(std::malloc(B));
  if (!buf) {
    std::fclose(f);
    return -1;
  }
  const bool counting = out_keys == nullptr;
  long rows = 0;
  bool range_error = false;  // a value outside int32: hard error (-2)

  // Per-line state.  VMAX bounds a VALUE field; longer fields are
  // malformed rows in BOTH parsers (the strict grammar below).
  const int VMAX = 63;
  unsigned char keybuf[256];  // key prefix (key_width <= 256 enforced)
  unsigned char valbuf[VMAX];
  long klen = 0;        // total key bytes seen
  long last_ns = -1;    // index of last non-space key byte
  int vlen = 0;
  long pending_cr = 0;  // run of '\r' that may be the CRLF terminator
  bool in_value = false;
  bool val_too_long = false;
  if (key_width > 256) {
    std::free(buf);
    std::fclose(f);
    return -1;
  }

  auto isws = [](unsigned char c) {
    return c == ' ' || c == '\t' || c == '\r';
  };

  auto finish_line = [&]() {
    long eff = last_ns + 1;  // key length after trailing-space strip
    bool ok = eff > 0 && in_value && !val_too_long;
    long long value = 0;
    if (ok) {
      // The STRICT value grammar both parsers implement:
      //   [ws]* [+-]? [0-9]+ [ws]*      (ws = ' ' '\t' '\r')
      // Anything else (letters, NULs, underscores, second tabs) skips
      // the row; a syntactically valid value outside int32 is a HARD
      // error for the whole file (silent wrap would corrupt counts).
      int j = 0;
      while (j < vlen && isws(valbuf[j])) ++j;
      long long sign = 1;
      if (j < vlen && (valbuf[j] == '+' || valbuf[j] == '-')) {
        sign = valbuf[j] == '-' ? -1 : 1;
        ++j;
      }
      const int digits_start = j;
      while (j < vlen && valbuf[j] >= '0' && valbuf[j] <= '9') {
        if (value < (1LL << 40))  // keep accumulating until clearly over
          value = value * 10 + (valbuf[j] - '0');
        ++j;
      }
      if (j == digits_start) ok = false;  // no digits
      while (j < vlen && isws(valbuf[j])) ++j;
      if (j != vlen) ok = false;  // trailing junk (incl. NUL bytes)
      value *= sign;
      if (ok && (value > 2147483647LL || value < -2147483648LL))
        range_error = true;
    }
    if (ok && !range_error) {
      if (!counting && rows < max_rows) {
        long keep = eff < key_width ? eff : key_width;
        std::memset(out_keys + rows * key_width, 0,
                    static_cast<size_t>(key_width));
        std::memcpy(out_keys + rows * key_width, keybuf,
                    static_cast<size_t>(keep));
        out_values[rows] = static_cast<int>(value);
        ++rows;
      } else if (counting) {
        ++rows;
      }
    }
    klen = 0;
    last_ns = -1;
    vlen = 0;
    pending_cr = 0;
    in_value = false;
    val_too_long = false;
  };

  for (;;) {
    long got = static_cast<long>(std::fread(buf, 1, B, f));
    if (got <= 0) break;
    for (long i = 0; i < got && !range_error; ++i) {
      const unsigned char c = buf[i];
      if (c == '\n') {
        finish_line();
      } else if (!in_value) {
        if (c == '\t') {
          in_value = true;
        } else {
          if (c != ' ') last_ns = klen;  // only ' ' strips from key tails (Q5)
          if (klen < key_width) keybuf[klen] = c;
          ++klen;
        }
      } else {
        // Trailing '\r' runs are the line terminator, not value bytes
        // (the Python path rstrips them from the LINE before its length
        // check); only '\r's later followed by a non-'\r' byte are value
        // content and count toward the field budget.
        if (c == '\r') {
          ++pending_cr;
        } else {
          while (pending_cr > 0 && vlen < VMAX) {
            valbuf[vlen++] = '\r';
            --pending_cr;
          }
          if (pending_cr > 0) val_too_long = true;
          pending_cr = 0;
          if (vlen < VMAX) valbuf[vlen++] = c;
          else val_too_long = true;
        }
      }
    }
    if (range_error) break;
  }
  const bool io_error = std::ferror(f) != 0;
  if (!range_error && !io_error && (klen > 0 || in_value))
    finish_line();  // trailing line without '\n'
  std::free(buf);
  std::fclose(f);
  if (io_error) return -1;       // mid-file read error, NOT a short file
  if (range_error) return -2;    // int32 overflow in a value
  return rows;
}

}  // extern "C"
