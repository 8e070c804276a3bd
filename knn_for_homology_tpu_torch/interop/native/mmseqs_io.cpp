// Native MMseqs2 database record I/O: the prefilter writer and the result
// reader of interop/mmseqs_format.py in C++, with buffered writes, mmap'd
// reads and raw number parsing. interop/native/__init__.py builds this file
// at first use and binds it with ctypes.
//
// The Python functions are the reference: on the same inputs this code
// writes the same bytes and returns the same arrays, and where the Python
// code raises, an entry point here returns an error code that the binding
// raises as the same exception type:
//  - a kept score is printed as Python's int() of the double prints it,
//    exactly at any magnitude (1e30 x 100 has 33 digits); NaN raises
//    ValueError and +-inf OverflowError there, so both are errors here;
//  - a record keeps only its lines that end in '\n' (Python splits the
//    record on '\n' and drops the last piece);
//  - column 0 and the E-value column are parsed strictly (an empty or
//    malformed field raises there); a line with fewer columns than the
//    E-value column asks for gets E = 0, and a negative column counts from
//    the end of the line, as Python's indexing does.

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <cerrno>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <version>

namespace {

// error codes shared with the binding
enum Status : int {
    OK = 0,
    OS_ERROR = 1,       // errno says why -> OSError
    VALUE_ERROR = 2,    // NaN score, malformed field or index line
    OVERFLOW_ERROR = 3, // infinite score, an id beyond int64
    INDEX_ERROR = 4,    // a record outside the data files, a missing column
};

bool is_space(char c) {
    return c == ' ' || c == '\r' || c == '\v' || c == '\f' || c == '\t' ||
           c == '\n';
}

// Trim ASCII whitespace from [*b, *e), as Python's int() / float() do.
void trim(const char** b, const char** e) {
    while (*b < *e && is_space(**b)) ++*b;
    while (*e > *b && is_space((*e)[-1])) --*e;
}

// Python's int() of a field: optional sign, decimal digits, whitespace
// around them.
Status parse_int(const char* b, const char* e, int64_t* out) {
    trim(&b, &e);
    if (b < e && *b == '+') {  // from_chars takes '-' only
        ++b;
        if (b < e && *b == '-') return VALUE_ERROR;
    }
    if (b == e || *b == '+') return VALUE_ERROR;
    auto [end, ec] = std::from_chars(b, e, *out);
    if (ec == std::errc::result_out_of_range) return OVERFLOW_ERROR;
    if (ec != std::errc() || end != e) return VALUE_ERROR;
    return OK;
}

// Python's float() of a field, correctly rounded as Python's is. strtod
// also reads hex floats and "nan(...)", which Python refuses: only decimal
// digits, signs, '.', exponents and the letters of inf / infinity / nan
// pass. from_chars (where the library has it for double) is the fast
// route; strtod takes what it cannot represent (Python gives inf or 0 there).
Status parse_float(const char* b, const char* e, double* out) {
    trim(&b, &e);
    if (b < e && *b == '+') {  // from_chars takes '-' only
        ++b;
        if (b < e && *b == '-') return VALUE_ERROR;
    }
    if (b == e || *b == '+') return VALUE_ERROR;
    for (const char* p = b; p < e; ++p) {
        if (*p == '\0' || !std::strchr("0123456789+-.eEinfatyINFATY", *p))
            return VALUE_ERROR;
    }
#if defined(__cpp_lib_to_chars)
    auto [end, ec] = std::from_chars(b, e, *out);
    if (ec == std::errc()) return end == e ? OK : VALUE_ERROR;
    if (ec != std::errc::result_out_of_range) return VALUE_ERROR;
#endif
    std::string field(b, e);  // strtod needs a NUL after the field
    char* end_s = nullptr;
    *out = std::strtod(field.c_str(), &end_s);
    return end_s == field.c_str() + field.size() ? OK : VALUE_ERROR;
}

// A read-only mmap of one data file. UniRef90-scale result DBs are tens of
// GB: the kernel pages in only the records that are read.
struct MappedFile {
    const char* base = nullptr;
    int64_t size = 0;
    bool ok = false;

    explicit MappedFile(const std::string& path) {
        int fd = ::open(path.c_str(), O_RDONLY);
        if (fd < 0) return;
        struct stat st;
        if (::fstat(fd, &st) != 0) {
            int err = errno;
            ::close(fd);
            errno = err;
            return;
        }
        size = (int64_t)st.st_size;
        if (size == 0) {  // mmap refuses empty files
            ::close(fd);
            ok = true;
            return;
        }
        void* p = ::mmap(nullptr, (size_t)size, PROT_READ, MAP_PRIVATE, fd, 0);
        int err = errno;
        ::close(fd);  // the mapping keeps its own reference
        if (p == MAP_FAILED) {
            errno = err;
            return;
        }
        base = (const char*)p;
        ok = true;
    }
    MappedFile(const MappedFile&) = delete;
    MappedFile& operator=(const MappedFile&) = delete;
    MappedFile(MappedFile&& o) noexcept : base(o.base), size(o.size), ok(o.ok) {
        o.base = nullptr;
        o.size = 0;
    }
    ~MappedFile() {
        if (base) ::munmap((void*)base, (size_t)size);
    }
};

// Parse one record, [r, r_end) without its last byte (the NUL), into
// targets and E-values.
Status parse_record(const char* r, const char* r_end, int evalue_col,
                    std::vector<int64_t>* targets,
                    std::vector<double>* evalues) {
    while (r < r_end) {
        const char* nl = (const char*)std::memchr(r, '\n', r_end - r);
        if (!nl) break;  // Python drops the piece after the last '\n'
        const char* tab = (const char*)std::memchr(r, '\t', nl - r);
        int64_t target;
        Status s = parse_int(r, tab ? tab : nl, &target);
        if (s != OK) return s;
        int col = evalue_col;
        if (col < 0) {  // cols[col] counts from the end of the line
            int n_cols = 1;
            for (const char* p = r; p < nl; ++p) n_cols += *p == '\t';
            col += n_cols;
            if (col < 0) return INDEX_ERROR;
        }
        // find column `col`: the text after its col-th tab
        const char* field = r;
        for (int c = 0; c < col && field; ++c) {
            const char* t = (const char*)std::memchr(field, '\t', nl - field);
            field = t ? t + 1 : nullptr;
        }
        double ev = 0.0;
        if (field) {
            const char* t = (const char*)std::memchr(field, '\t', nl - field);
            s = parse_float(field, t ? t : nl, &ev);
            if (s != OK) return s;
        }
        targets->push_back(target);
        evalues->push_back(ev);
        r = nl + 1;
    }
    return OK;
}

struct Records {
    std::vector<int64_t> qids, counts, targets;
    std::vector<double> evalues;
};

// Write n bytes, recording a failure once.
struct Writer {
    FILE* fp;
    bool ok = true;
    void put(const char* p, size_t n) {
        if (ok && std::fwrite(p, 1, n, fp) != n) ok = false;
    }
};

// Python's str(int(x)) of a finite double: truncation toward zero, printed
// exactly. Integral doubles below 2^63 go through an int64; wider ones are
// printed by %.0f, exact in glibc for integral values. `+ 0.0` turns -0
// into 0.
int format_trunc(double x, char* out, size_t cap) {
    double t = std::trunc(x) + 0.0;
    if (std::fabs(t) < 9.2e18) {
        auto res = std::to_chars(out, out + cap, (long long)t);
        return (int)(res.ptr - out);
    }
    return std::snprintf(out, cap, "%.0f", t);
}

}  // namespace

extern "C" {

// Parse a result DB. data_paths: the data files in order, '\n'-separated.
// Returns an opaque handle and sets n_queries / n_entries, or returns
// nullptr and sets *status (and errno for OS_ERROR).
void* rr_open(const char* index_path, const char* data_paths, int evalue_col,
              int64_t* n_queries, int64_t* n_entries, int* status) {
    *status = OK;
    MappedFile index(index_path);  // the index first, as Python reads it
    if (!index.ok) {
        *status = OS_ERROR;
        return nullptr;
    }
    std::vector<MappedFile> maps;
    std::vector<int64_t> starts;  // cumulative global offset of each file
    int64_t total = 0;
    for (const char* p = data_paths; *p;) {
        const char* end = std::strchr(p, '\n');
        size_t len = end ? (size_t)(end - p) : std::strlen(p);
        maps.emplace_back(std::string(p, len));
        if (!maps.back().ok) {
            *status = OS_ERROR;
            return nullptr;
        }
        starts.push_back(total);
        total += maps.back().size;
        p += len + (end ? 1 : 0);
    }
    auto recs = new Records();
    Status s = OK;
    const char* p = index.base;
    const char* index_end = index.base + index.size;
    while (p < index_end && s == OK) {
        const char* nl = (const char*)std::memchr(p, '\n', index_end - p);
        const char* line_end = nl ? nl : index_end;
        // exactly three tab-separated fields: qid, offset, size
        int64_t f[3];
        const char* field = p;
        for (int c = 0; c < 3 && s == OK; ++c) {
            const char* t = (const char*)std::memchr(field, '\t', line_end - field);
            if ((c < 2) != (t != nullptr)) {
                s = VALUE_ERROR;
                break;
            }
            s = parse_int(field, t ? t : line_end, &f[c]);
            field = t ? t + 1 : line_end;
        }
        if (s != OK) break;
        p = nl ? nl + 1 : index_end;

        // the first file the offset falls in (records never span files)
        int64_t offset = f[1], size = f[2];
        const char* r = nullptr;
        for (size_t i = 0; i < maps.size() && offset >= 0; ++i) {
            int64_t rel = offset - starts[i];
            if (rel < maps[i].size) {
                if (rel + size - 1 <= maps[i].size) r = maps[i].base + rel;
                break;
            }
        }
        if (!r) {
            s = INDEX_ERROR;
            break;
        }
        size_t before = recs->targets.size();
        s = parse_record(r, r + size - 1, evalue_col, &recs->targets,
                         &recs->evalues);
        recs->qids.push_back(f[0]);
        recs->counts.push_back((int64_t)(recs->targets.size() - before));
    }
    if (s != OK) {
        delete recs;
        *status = s;
        return nullptr;
    }
    *n_queries = (int64_t)recs->qids.size();
    *n_entries = (int64_t)recs->targets.size();
    return recs;
}

void rr_fill(void* h, int64_t* query_ids, int64_t* counts, int64_t* targets,
             double* evalues) {
    auto recs = static_cast<Records*>(h);
    std::memcpy(query_ids, recs->qids.data(), recs->qids.size() * 8);
    std::memcpy(counts, recs->counts.data(), recs->counts.size() * 8);
    std::memcpy(targets, recs->targets.data(), recs->targets.size() * 8);
    std::memcpy(evalues, recs->evalues.data(), recs->evalues.size() * 8);
}

void rr_close(void* h) { delete static_cast<Records*>(h); }

// Write a prefilter DB data + index pair. hits [nq, k]: the engine's ids,
// -1 = missing (skipped); targets [nq, k]: the MMseqs2 ids to print for
// them; scores_x100 [nq, k]. Returns a Status (errno set for OS_ERROR).
int pf_write(const char* data_path, const char* index_path,
             const int64_t* query_mmseqs_ids, int64_t nq, const int64_t* hits,
             const int64_t* targets, const double* scores_x100, int64_t k) {
    FILE* data = std::fopen(data_path, "wb");
    if (!data) return OS_ERROR;
    FILE* index = std::fopen(index_path, "wb");
    if (!index) {
        int err = errno;
        std::fclose(data);
        errno = err;
        return OS_ERROR;
    }
    std::vector<char> buf(1 << 20), index_buf(1 << 18);
    std::setvbuf(data, buf.data(), _IOFBF, buf.size());
    std::setvbuf(index, index_buf.data(), _IOFBF, index_buf.size());
    Writer out{data}, idx{index};
    Status s = OK;
    int64_t offset = 0;
    // the widest line: a 20-character id, DBL_MAX's 309 digits and a sign
    char line[400];
    for (int64_t q = 0; q < nq && s == OK && out.ok && idx.ok; ++q) {
        int64_t length = 0;
        for (int64_t j = 0; j < k; ++j) {
            int64_t at = q * k + j;
            if (hits[at] == -1) continue;
            double score = scores_x100[at];
            if (std::isnan(score)) s = VALUE_ERROR;
            if (std::isinf(score)) s = OVERFLOW_ERROR;
            if (s != OK) break;
            char* p = std::to_chars(line, line + 21, (long long)targets[at]).ptr;
            *p++ = '\t';
            p += format_trunc(score, p, line + sizeof(line) - 3 - p);
            std::memcpy(p, "\t0\n", 3);
            p += 3;
            out.put(line, p - line);
            length += p - line;
        }
        if (s != OK) break;
        out.put("", 1);  // the record's NUL
        length += 1;
        int n = std::snprintf(line, sizeof(line), "%lld\t%lld\t%lld\n",
                              (long long)query_mmseqs_ids[q],
                              (long long)offset, (long long)length);
        idx.put(line, n);
        offset += length;
    }
    int err = out.ok && idx.ok ? 0 : errno;
    bool closed = (std::fclose(data) == 0) & (std::fclose(index) == 0);
    if (s != OK) return s;
    if (err || !closed) {
        if (err) errno = err;
        return OS_ERROR;
    }
    return OK;
}

}  // extern "C"
