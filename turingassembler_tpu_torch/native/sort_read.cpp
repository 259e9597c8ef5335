// Host barcode read sorter: the port's twin of the JAX package's
// native/sort_read.cpp (its libtasort.so), built by _build.build_host and
// bound in barcode/sort_read.py (_sort_reads_native).  A rebuild of the
// reference's sort_read (src/sort_read.c:660, per-thread radix sort +
// k-way disk merge).
//
// Produces the same durable artifacts as the Python loop of
// barcode/sort_read.py, byte for byte: R1.sorted.fq / R2.sorted.fq with
// records re-emitted as '@name BX:Z:<bc> QB:Z:<q>' and a 40-byte-per-
// barcode little-endian barcode.idx (barcode u64, off1, off2, len1,
// len2).
//
// Each input file is parsed whole on its own thread (R1, R2 and the
// index read at once).  Formatted records accumulate in two byte arenas;
// when the arenas and their record list exceed `mem_budget_bytes` (the
// CLI's -sm, reference src/main.c:234-236) the current records are
// stable-sorted by barcode and spilled to a sorted run file, and the
// runs are k-way merged at the end (the reference's
// merge_sorted_small/large, src/sort_read.c:149-210,567-658).  With no
// spill the single run is written directly; both paths are
// byte-identical to the Python loop.  lib_type codes: 1 BioT, 2 UST,
// 3 10X.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <string>
#include <thread>
#include <vector>

#include "zlib_decl.h"

namespace {

constexpr size_t CHUNK = 1 << 20;
constexpr uint64_t BX_NONE = 0xFFFFFFFFFFFFFFFFull;

int8_t NT4S[256];
struct Nt4InitS {
    Nt4InitS() {
        memset(NT4S, 4, sizeof(NT4S));
        NT4S[(int)'A'] = NT4S[(int)'a'] = 0;
        NT4S[(int)'C'] = NT4S[(int)'c'] = 1;
        NT4S[(int)'G'] = NT4S[(int)'g'] = 2;
        NT4S[(int)'T'] = NT4S[(int)'t'] = 3;
    }
} nt4_init_s;

struct LineReader {
    gzFile gz = nullptr;
    FILE *fp = nullptr;
    std::vector<char> buf;
    size_t pos = 0, len = 0;
    bool eof = false;

    bool open(const char *path) {
        size_t n = strlen(path);
        if (n > 3 && strcmp(path + n - 3, ".gz") == 0) {
            gz = gzopen(path, "rb");
            if (!gz) return false;
            gzbuffer(gz, 1 << 20);
        } else {
            fp = fopen(path, "rb");
            if (!fp) return false;
        }
        buf.resize(CHUNK * 2);
        return true;
    }
    void close() {
        if (gz) gzclose(gz);
        if (fp) fclose(fp);
        gz = nullptr;
        fp = nullptr;
    }
    bool fill() {
        if (pos > 0) {
            memmove(buf.data(), buf.data() + pos, len - pos);
            len -= pos;
            pos = 0;
        }
        if (buf.size() - len < CHUNK) buf.resize(len + CHUNK);
        long n = gz ? gzread(gz, buf.data() + len, CHUNK)
                    : (long)fread(buf.data() + len, 1, CHUNK, fp);
        if (n <= 0) {
            eof = true;
            return false;
        }
        len += (size_t)n;
        return true;
    }
    // next line into out (copied: the buffer may move under refills)
    bool next_line(std::string &out) {
        while (true) {
            char *nl = (char *)memchr(buf.data() + pos, '\n', len - pos);
            if (nl) {
                out.assign(buf.data() + pos,
                           (size_t)(nl - (buf.data() + pos)));
                pos = (size_t)(nl - buf.data()) + 1;
                return true;
            }
            if (eof) {
                if (pos < len) {
                    out.assign(buf.data() + pos, len - pos);
                    pos = len;
                    return true;
                }
                return false;
            }
            fill();
        }
    }
    // one FASTQ record; false at EOF, sets *err on malformed input
    bool next_record(std::string &hdr, std::string &seq, std::string &qual,
                     bool *err) {
        std::string plus;
        do {
            if (!next_line(hdr)) return false;
        } while (hdr.empty());
        if (hdr[0] != '@') {
            *err = true;
            return false;
        }
        hdr.erase(0, 1);
        if (!next_line(seq) || !next_line(plus) || !next_line(qual)) {
            *err = true;
            return false;
        }
        return true;
    }
};

// A chunk of parsed FASTQ records: raw fields concatenated in `blob`,
// 3 offsets per record (hdr, seq, qual starts) + final terminator.
// Parsing (gzip inflate + record chunking) is the dominant cost, so
// the R1/R2/I files parse their chunks on their own threads — the same
// producer-per-file layout as the reference (init_fastq_triple,
// src/fastq_producer.c:125+).  The JAX package parses each file whole;
// here a chunk is at most `chunk_records` records, so what the sort
// holds beside its arenas is bounded.
struct ParsedFile {
    std::vector<char> blob;
    std::vector<size_t> offs;
    bool err = false;

    int64_t n_records() const {
        return offs.empty() ? 0 : (int64_t)((offs.size() - 1) / 3);
    }
    void field(int64_t i, int f, const char *&p, size_t &len) const {
        size_t a = offs[(size_t)(3 * i + f)];
        size_t b = offs[(size_t)(3 * i + f + 1)];
        p = blob.data() + a;
        len = b - a;
    }
};

void parse_chunk(LineReader *r, int64_t chunk_records, ParsedFile *out) {
    out->blob.clear();
    out->offs.clear();
    std::string h, s, q;
    bool err = false;
    for (int64_t n = 0; n < chunk_records && r->next_record(h, s, q, &err);
         ++n) {
        out->offs.push_back(out->blob.size());
        out->blob.insert(out->blob.end(), h.begin(), h.end());
        out->offs.push_back(out->blob.size());
        out->blob.insert(out->blob.end(), s.begin(), s.end());
        out->offs.push_back(out->blob.size());
        out->blob.insert(out->blob.end(), q.begin(), q.end());
    }
    out->offs.push_back(out->blob.size());
    out->err = err;
}

uint64_t decode_bc(const char *s, size_t n) {
    uint64_t ret = 0;
    for (size_t i = 0; i < n; i++)
        ret = ret * 5 + (uint64_t)NT4S[(int)(unsigned char)s[i]];
    return ret;
}

// name = header up to first space; returns comment span after the space
void split_header(const std::string &hdr, size_t &name_len, size_t &com_off) {
    size_t sp = hdr.find(' ');
    if (sp == std::string::npos) {
        name_len = hdr.size();
        com_off = hdr.size();
    } else {
        name_len = sp;
        com_off = sp + 1;
    }
}

// BX:Z:/QB:Z: tag spans inside a comment (match _extract_barcode_biot)
bool find_tag(const std::string &s, size_t from, const char *tag,
              size_t &off, size_t &tlen) {
    size_t i = s.find(tag, from);
    if (i == std::string::npos) return false;
    off = i + 5;
    size_t e = off;
    while (e < s.size() && s[e] != ' ' && s[e] != '\t') e++;
    tlen = e - off;
    return true;
}

struct Arena {
    std::vector<char> data;
    void append(const char *p, size_t n) { data.insert(data.end(), p, p + n); }
    void append(const std::string &s) { append(s.data(), s.size()); }
    void append(char c) { data.push_back(c); }
};

struct RecMeta {
    uint64_t bc;
    uint64_t off1, off2;
    uint32_t len1, len2;
};

void emit_record(Arena &a, const std::string &hdr, size_t name_len,
                 const std::string &tag, const char *seq, size_t seq_len,
                 const char *qual, size_t qual_len) {
    a.append('@');
    a.append(hdr.data(), name_len);
    a.append(tag);
    a.append('\n');
    a.append(seq, seq_len);
    a.append("\n+\n", 3);
    a.append(qual, qual_len);
    a.append('\n');
}

// One spilled sorted run: [u64 bc][u32 len1][u32 len2][r1 text][r2 text]*
struct RunWriter {
    static int64_t flush(Arena &a1, Arena &a2, std::vector<RecMeta> &metas,
                         const std::string &path) {
        std::vector<int64_t> order(metas.size());
        std::iota(order.begin(), order.end(), 0);
        std::stable_sort(order.begin(), order.end(),
                         [&](int64_t x, int64_t y) {
                             return metas[(size_t)x].bc < metas[(size_t)y].bc;
                         });
        FILE *f = fopen(path.c_str(), "wb");
        if (!f) return -1;
        std::vector<char> ob(1 << 22);
        setvbuf(f, ob.data(), _IOFBF, ob.size());
        for (int64_t oi : order) {
            const RecMeta &m = metas[(size_t)oi];
            fwrite(&m.bc, 8, 1, f);
            fwrite(&m.len1, 4, 1, f);
            fwrite(&m.len2, 4, 1, f);
            fwrite(a1.data.data() + m.off1, 1, m.len1, f);
            fwrite(a2.data.data() + m.off2, 1, m.len2, f);
        }
        bool bad = ferror(f) != 0;
        bad |= fclose(f) != 0;
        a1.data.clear();
        a2.data.clear();
        metas.clear();
        return bad ? -1 : 0;
    }
};

struct RunReader {
    FILE *f = nullptr;
    std::vector<char> buf;
    uint64_t bc = 0;
    uint32_t len1 = 0, len2 = 0;
    std::vector<char> rec;  // r1 text followed by r2 text
    bool ok = false;
    bool bad = false;       // a read error or a record cut short

    bool open(const std::string &path) {
        f = fopen(path.c_str(), "rb");
        if (!f) return false;
        buf.resize(1 << 22);
        setvbuf(f, buf.data(), _IOFBF, buf.size());
        return next();
    }
    bool next() {
        if (fread(&bc, 8, 1, f) != 1) {   // the run's clean end
            ok = false;
            bad = ferror(f) != 0;
            return false;
        }
        ok = fread(&len1, 4, 1, f) == 1 && fread(&len2, 4, 1, f) == 1;
        if (ok) {
            rec.resize((size_t)len1 + len2);
            ok = fread(rec.data(), 1, rec.size(), f) == rec.size();
        }
        bad = !ok;
        return ok;
    }
    void close() {
        if (f) fclose(f);
        f = nullptr;
    }
};

struct SortOutput {
    FILE *f1, *f2, *fi;
    std::vector<char> ob1, ob2;
    uint64_t off1 = 0, off2 = 0, poff1 = 0, poff2 = 0;
    uint64_t prev_bc = 0;
    bool have_prev = false;

    bool open(const char *out_r1, const char *out_r2, const char *out_idx) {
        f1 = fopen(out_r1, "wb");
        f2 = fopen(out_r2, "wb");
        fi = fopen(out_idx, "wb");
        if (!f1 || !f2 || !fi) {
            if (f1) fclose(f1);
            if (f2) fclose(f2);
            if (fi) fclose(fi);
            return false;
        }
        ob1.resize(1 << 22);
        ob2.resize(1 << 22);
        setvbuf(f1, ob1.data(), _IOFBF, ob1.size());
        setvbuf(f2, ob2.data(), _IOFBF, ob2.size());
        return true;
    }
    void write_idx(uint64_t bc) {
        uint64_t rec[5] = {bc, poff1, poff2, off1 - poff1, off2 - poff2};
        fwrite(rec, 8, 5, fi);  // struct.pack("<QQQQQ") on LE hosts
        poff1 = off1;
        poff2 = off2;
    }
    void put(uint64_t bc, const char *r1, uint32_t l1, const char *r2,
             uint32_t l2) {
        if (have_prev && bc != prev_bc) write_idx(prev_bc);
        fwrite(r1, 1, l1, f1);
        fwrite(r2, 1, l2, f2);
        off1 += l1;
        off2 += l2;
        prev_bc = bc;
        have_prev = true;
    }
    // false if any write failed
    bool close() {
        if (have_prev) write_idx(prev_bc);
        bool bad = ferror(f1) || ferror(f2) || ferror(fi);
        bad |= fclose(f1) != 0;
        bad |= fclose(f2) != 0;
        bad |= fclose(fi) != 0;
        return !bad;
    }
};

}  // namespace

extern "C" {

// Returns the number of read pairs sorted, or one of the codes below.
// filesI may be null or shorter than n_files (UST pairs without an index
// read get BX_NONE).  Each file is parsed `chunk_records` records at a
// time.  `n_runs`, when not null, receives the number of sorted runs
// spilled to disk and merged (0 when everything was sorted in RAM).
enum {
    ERR_OPEN_INPUT = -1,     // an input file does not open
    ERR_WRITE_ARCHIVE = -2,  // the sorted archive cannot be written
    ERR_RUN_IO = -3,         // a spilled run cannot be written or read
    ERR_MALFORMED = -4,      // a record lacks its '@' or is truncated
    ERR_COUNTS = -5,         // paired files hold different read counts
    ERR_LIB_TYPE = -6,       // lib_type is not 1, 2 or 3
};

int64_t ta_sort_reads_budget(const char **files1, const char **files2,
                             const char **filesI, int64_t n_files,
                             int64_t n_filesI, int32_t lib_type,
                             const char *out_r1, const char *out_r2,
                             const char *out_idx,
                             int64_t mem_budget_bytes,
                             int64_t chunk_records, int64_t *n_runs) {
    if (lib_type != 1 && lib_type != 2 && lib_type != 3) return ERR_LIB_TYPE;
    if (chunk_records < 1) chunk_records = 1;
    Arena a1, a2;
    std::vector<RecMeta> metas;
    std::string h1, s1, q1, h2, s2, q2, tag;
    std::vector<std::string> run_paths;
    int64_t n_total = 0;
    std::string run_base(out_idx);
    run_base += ".run";
    auto maybe_spill = [&]() -> bool {
        if (mem_budget_bytes <= 0) return true;
        int64_t used = (int64_t)(a1.data.size() + a2.data.size() +
                                 metas.size() * sizeof(RecMeta));
        if (used < mem_budget_bytes || metas.empty()) return true;
        std::string p = run_base + "." + std::to_string(run_paths.size());
        if (RunWriter::flush(a1, a2, metas, p) < 0) return false;
        run_paths.push_back(p);
        return true;
    };

    for (int64_t fi = 0; fi < n_files; fi++) {
        bool have_I = lib_type == 2 && filesI && fi < n_filesI;
        LineReader r1, r2, rI;
        bool opened = r1.open(files1[fi]) && r2.open(files2[fi]) &&
                      (!have_I || rI.open(filesI[fi]));
        ParsedFile p1, p2, pI;
        int64_t n = opened ? 1 : 0;
        int rc = opened ? 0 : ERR_OPEN_INPUT;
        while (n > 0) {
            {
                std::thread t1(parse_chunk, &r1, chunk_records, &p1);
                std::thread t2(parse_chunk, &r2, chunk_records, &p2);
                std::thread tI;
                if (have_I)
                    tI = std::thread(parse_chunk, &rI, chunk_records, &pI);
                t1.join();
                t2.join();
                if (tI.joinable()) tI.join();
            }
            n = p1.n_records();
            if (p1.err || p2.err || (have_I && pI.err)) {
                rc = ERR_MALFORMED;
                break;
            }
            if (p2.n_records() != n || (have_I && pI.n_records() != n)) {
                rc = ERR_COUNTS;
                break;
            }
            for (int64_t i = 0; i < n; i++) {
                const char *ph;
                size_t lh;
                p1.field(i, 0, ph, lh);
                h1.assign(ph, lh);
                p1.field(i, 1, ph, lh);
                s1.assign(ph, lh);
                p1.field(i, 2, ph, lh);
                q1.assign(ph, lh);
                p2.field(i, 0, ph, lh);
                h2.assign(ph, lh);
                p2.field(i, 1, ph, lh);
                s2.assign(ph, lh);
                p2.field(i, 2, ph, lh);
                q2.assign(ph, lh);
                const char *bseq = nullptr, *bqual = nullptr;
                size_t blen = 0, bqlen = 0;
                const char *o_seq1 = s1.data(), *o_qual1 = q1.data();
                size_t o_len1 = s1.size(), o_qlen1 = q1.size();
                uint64_t bc = BX_NONE;
                if (lib_type == 2) {  // UST: separate index read
                    if (have_I) {
                        const char *pi_s, *pi_q;
                        size_t li_s, li_q;
                        pI.field(i, 1, pi_s, li_s);
                        pI.field(i, 2, pi_q, li_q);
                        if (li_s) {
                            bseq = pi_s;
                            blen = li_s;
                            bqual = pi_q;
                            bqlen = li_q;
                            bc = decode_bc(bseq, blen);
                        }
                    }
                } else if (lib_type == 1) {  // BioT: BX:Z: in the comment
                    size_t name_len, com_off;
                    split_header(h1, name_len, com_off);
                    size_t boff, bl;
                    if (find_tag(h1, com_off, "BX:Z:", boff, bl)) {
                        bseq = h1.data() + boff;
                        blen = bl;
                        bc = decode_bc(bseq, blen);
                        size_t qoff, ql;
                        if (find_tag(h1, com_off, "QB:Z:", qoff, ql)) {
                            bqual = h1.data() + qoff;
                            bqlen = ql;
                        }
                    }
                } else {  // 10X: 16bp barcode + 7bp UMI
                    if (s1.size() >= 23) {
                        bseq = s1.data();
                        blen = 16;
                        bqual = q1.data();
                        bqlen = 16;
                        bc = decode_bc(bseq, 16);
                        o_seq1 = s1.data() + 23;
                        o_len1 = s1.size() - 23;
                        o_qual1 = q1.data() + 23;
                        o_qlen1 = q1.size() >= 23 ? q1.size() - 23 : 0;
                    }
                }
                tag.clear();
                if (blen) {
                    tag += " BX:Z:";
                    tag.append(bseq, blen);
                    tag += " QB:Z:";
                    if (bqlen) tag.append(bqual, bqlen);
                }
                size_t n1l, c1;
                split_header(h1, n1l, c1);
                size_t n2l, c2;
                split_header(h2, n2l, c2);
                RecMeta m;
                m.bc = bc;
                m.off1 = a1.data.size();
                m.off2 = a2.data.size();
                emit_record(a1, h1, n1l, tag, o_seq1, o_len1, o_qual1,
                            o_qlen1);
                emit_record(a2, h2, n2l, tag, s2.data(), s2.size(),
                            q2.data(), q2.size());
                m.len1 = (uint32_t)(a1.data.size() - m.off1);
                m.len2 = (uint32_t)(a2.data.size() - m.off2);
                metas.push_back(m);
                ++n_total;
                if (!maybe_spill()) {
                    rc = ERR_RUN_IO;
                    break;
                }
            }
            if (rc) break;
        }
        r1.close();
        r2.close();
        rI.close();
        if (rc) {
            for (const std::string &p : run_paths) remove(p.c_str());
            return rc;
        }
    }

    SortOutput out;
    if (!out.open(out_r1, out_r2, out_idx)) return ERR_WRITE_ARCHIVE;

    if (run_paths.empty()) {
        if (n_runs) *n_runs = 0;
        // all in RAM: stable sort by barcode preserves input order
        // within a barcode, matching numpy argsort(kind="stable")
        std::vector<int64_t> order(metas.size());
        std::iota(order.begin(), order.end(), 0);
        std::stable_sort(order.begin(), order.end(),
                         [&](int64_t x, int64_t y) {
                             return metas[(size_t)x].bc < metas[(size_t)y].bc;
                         });
        for (int64_t oi : order) {
            const RecMeta &m = metas[(size_t)oi];
            out.put(m.bc, a1.data.data() + m.off1, m.len1,
                    a2.data.data() + m.off2, m.len2);
        }
        return out.close() ? n_total : (int64_t)ERR_WRITE_ARCHIVE;
    }

    // spill the tail records, then k-way merge the sorted runs; ties on
    // barcode break toward the lowest run index (runs are in input
    // order) so the merged stream equals the global stable sort
    if (!metas.empty()) {
        std::string p = run_base + "." + std::to_string(run_paths.size());
        if (RunWriter::flush(a1, a2, metas, p) < 0) return ERR_RUN_IO;
        run_paths.push_back(p);
    }
    if (n_runs) *n_runs = (int64_t)run_paths.size();
    std::vector<RunReader> runs(run_paths.size());
    for (size_t i = 0; i < run_paths.size(); ++i)
        if (!runs[i].open(run_paths[i])) return ERR_RUN_IO;
    typedef std::pair<uint64_t, size_t> HeapItem;  // (barcode, run idx)
    auto cmp = [](const HeapItem &a, const HeapItem &b) { return a > b; };
    std::vector<HeapItem> heap;
    for (size_t i = 0; i < runs.size(); ++i)
        if (runs[i].ok) heap.push_back({runs[i].bc, i});
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (!heap.empty()) {
        std::pop_heap(heap.begin(), heap.end(), cmp);
        size_t ri = heap.back().second;
        heap.pop_back();
        RunReader &r = runs[ri];
        out.put(r.bc, r.rec.data(), r.len1, r.rec.data() + r.len1, r.len2);
        if (r.next()) {
            heap.push_back({r.bc, ri});
            std::push_heap(heap.begin(), heap.end(), cmp);
        }
    }
    bool written = out.close();
    bool runs_ok = true;
    for (size_t i = 0; i < runs.size(); ++i) {
        runs_ok &= !runs[i].bad;
        runs[i].close();
        remove(run_paths[i].c_str());
    }
    if (!written) return ERR_WRITE_ARCHIVE;
    return runs_ok ? n_total : (int64_t)ERR_RUN_IO;
}

}  // extern "C"
