// Host FASTQ reader: FASTQ(.gz) records to padded uint8 code batches.
//
// The port's twin of the JAX package's native/fastq_reader.cpp (its
// libtafq.so), built by _build.build_host and bound in
// io/native_loader.py.  It yields the same batches: codes A0 C1 G2 T3,
// 4 for any other byte, 255 pad; lengths min(len, pad_to); the
// '@'-stripped header lines.  Blank lines before a header are skipped,
// only the '@' of a header is checked, and a truncated record is an
// error (-1).
//
// Headers go to a buffer the reader owns and grows, so every header of a
// batch arrives whole (the JAX library copies into a caller's buffer of
// fixed size and stops copying, silently, once a batch's headers pass
// it).  Read them with tafq_headers after each batch.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include "zlib_decl.h"

namespace {

constexpr size_t CHUNK = 1 << 20;

int8_t NT4[256];
struct Nt4Init {
    Nt4Init() {
        memset(NT4, 4, sizeof(NT4));
        NT4[(int)'A'] = NT4[(int)'a'] = 0;
        NT4[(int)'C'] = NT4[(int)'c'] = 1;
        NT4[(int)'G'] = NT4[(int)'g'] = 2;
        NT4[(int)'T'] = NT4[(int)'t'] = 3;
    }
} nt4_init;

struct Reader {
    gzFile gz = nullptr;
    FILE *fp = nullptr;
    std::vector<char> buf;
    size_t pos = 0;      // parse cursor
    size_t len = 0;      // valid bytes
    bool eof = false;
    std::vector<char> headers;   // this batch's headers, back to back

    void fill() {
        if (pos > 0) {   // compact, then refill
            memmove(buf.data(), buf.data() + pos, len - pos);
            len -= pos;
            pos = 0;
        }
        if (buf.size() - len < CHUNK) buf.resize(len + CHUNK);
        long n = gz ? (long)gzread(gz, buf.data() + len, (unsigned)CHUNK)
                    : (long)fread(buf.data() + len, 1, CHUNK, fp);
        if (n <= 0) {
            eof = true;
            return;
        }
        len += (size_t)n;
    }

    // next line [start, end) without its newline; false at EOF.  A fill
    // may move the buffer, so a line is consumed before the next call.
    bool next_line(size_t &start, size_t &end) {
        while (true) {
            char *nl = (char *)memchr(buf.data() + pos, '\n', len - pos);
            if (nl) {
                start = pos;
                end = (size_t)(nl - buf.data());
                pos = end + 1;
                return true;
            }
            if (eof) {
                if (pos < len) {  // last line without newline
                    start = pos;
                    end = len;
                    pos = len;
                    return true;
                }
                return false;
            }
            fill();
        }
    }
};

}  // namespace

extern "C" {

void *tafq_open(const char *path) {
    Reader *r = new Reader();
    size_t n = strlen(path);
    if (n > 3 && strcmp(path + n - 3, ".gz") == 0) {
        r->gz = gzopen(path, "rb");
        if (!r->gz) { delete r; return nullptr; }
        gzbuffer(r->gz, 1 << 20);
    } else {
        r->fp = fopen(path, "rb");
        if (!r->fp) { delete r; return nullptr; }
    }
    r->buf.resize(CHUNK * 2);
    return r;
}

void tafq_close(void *h) {
    Reader *r = (Reader *)h;
    if (!r) return;
    if (r->gz) gzclose(r->gz);
    if (r->fp) fclose(r->fp);
    delete r;
}

// Read up to max_reads records.
//   bases:      max_reads * pad_to uint8, filled here (255 pad)
//   lengths:    max_reads int32, min(true length, pad_to)
//   header_off: max_reads + 1 int64 offsets of the headers in
//               tafq_headers' buffer, or nullptr to keep no headers
// Returns the number of records read, or -1 on malformed input.
long tafq_next_batch(void *h, long max_reads, long pad_to, uint8_t *bases,
                     int32_t *lengths, int64_t *header_off) {
    Reader *r = (Reader *)h;
    long nread = 0;
    r->headers.clear();
    if (header_off) header_off[0] = 0;
    memset(bases, 255, (size_t)max_reads * pad_to);
    while (nread < max_reads) {
        size_t s0, e0;
        if (!r->next_line(s0, e0)) break;
        if (e0 == s0) continue;  // blank line
        if (r->buf[s0] != '@') return -1;
        if (header_off) {
            r->headers.insert(r->headers.end(), r->buf.data() + s0 + 1,
                              r->buf.data() + e0);
            header_off[nread + 1] = (int64_t)r->headers.size();
        }
        size_t s1, e1, s2, e2, s3, e3;
        if (!r->next_line(s1, e1)) return -1;  // seq
        long sl = (long)(e1 - s1);
        long keep = sl < pad_to ? sl : pad_to;
        const char *seq = r->buf.data() + s1;
        uint8_t *dst = bases + (size_t)nread * pad_to;
        for (long i = 0; i < keep; ++i)
            dst[i] = (uint8_t)NT4[(int)(unsigned char)seq[i]];
        lengths[nread] = (int32_t)keep;
        if (!r->next_line(s2, e2)) return -1;  // +
        if (!r->next_line(s3, e3)) return -1;  // qual
        ++nread;
    }
    return nread;
}

// The headers of the last batch (header_off[n] bytes); valid until the
// next tafq_next_batch or tafq_close.
const char *tafq_headers(void *h) {
    return ((Reader *)h)->headers.data();
}

}  // extern "C"
