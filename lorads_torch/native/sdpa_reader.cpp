// Fast SDPA sparse-format (.dat-s) tokenizer (a copy of
// lorads_tpu/native/sdpa_reader.cpp).
//
// Native-path equivalent of the reference reader LReadSDPA
// (src_semi/io/lorads_file_io.c:21-417), redesigned as a two-stage
// pipeline: this C++ stage mmaps the file and tokenizes header + 5-tuple
// entries into flat arrays at memory bandwidth; the Python stage
// (lorads_torch/io/sdpa.py) applies the semantic rules (objective
// negation, lower-triangular normalization, 1e-12 drop, dedup) as
// vectorized NumPy ops.  Exposed via a C ABI for ctypes.
//
// Built on first use by lorads_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -o libsdpa_reader_<hash>.so sdpa_reader.cpp

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

struct Parsed {
    int64_t m = 0;
    int64_t n_blocks = 0;
    std::vector<int64_t> block_dims;
    std::vector<double> rhs;
    // entry arrays (raw, 1-based indices exactly as in the file)
    std::vector<int32_t> e_con, e_blk, e_row, e_col;
    std::vector<double> e_val;
    char error[256] = {0};
};

class Cursor {
  public:
    Cursor(const char* p, const char* end) : p_(p), end_(end) {}

    // Skip whitespace, separators and comment lines ('*' or '"').
    void skip() {
        for (;;) {
            while (p_ < end_ &&
                   (*p_ == ' ' || *p_ == '\t' || *p_ == ',' || *p_ == '(' ||
                    *p_ == ')' || *p_ == '{' || *p_ == '}' || *p_ == '\r' ||
                    *p_ == '\n' || *p_ == '\''))
                ++p_;
            if (p_ < end_ && at_line_start_comment()) {
                while (p_ < end_ && *p_ != '\n') ++p_;
                continue;
            }
            break;
        }
    }

    bool done() {
        skip();
        return p_ >= end_;
    }

    bool next_int(int64_t* out) {
        skip();
        if (p_ >= end_) return false;
        char* endp = nullptr;
        double v = strtod(p_, &endp);  // tolerate "1.0" style ints
        if (endp == p_) return false;
        p_ = endp;
        *out = (int64_t)v;
        return true;
    }

    bool next_double(double* out) {
        skip();
        if (p_ >= end_) return false;
        char* endp = nullptr;
        double v = strtod(p_, &endp);
        if (endp == p_) return false;
        p_ = endp;
        *out = v;
        return true;
    }

  private:
    bool at_line_start_comment() {
        if (*p_ != '*' && *p_ != '"') return false;
        // only treat as comment when at start of line
        const char* q = p_ - 1;
        while (q >= begin_guard_ && (*q == ' ' || *q == '\t')) --q;
        return q < begin_guard_ || *q == '\n';
    }

    const char* p_;
    const char* end_;
    const char* begin_guard_ = nullptr;

  public:
    void set_begin(const char* b) { begin_guard_ = b; }
};

}  // namespace

extern "C" {

void* sdpa_parse(const char* path) {
    int fd = open(path, O_RDONLY);
    auto* out = new Parsed();
    if (fd < 0) {
        snprintf(out->error, sizeof(out->error), "cannot open %s", path);
        return out;
    }
    struct stat st;
    fstat(fd, &st);
    size_t size = (size_t)st.st_size;
    const char* data =
        (const char*)mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    close(fd);
    if (data == MAP_FAILED) {
        snprintf(out->error, sizeof(out->error), "mmap failed for %s", path);
        return out;
    }

    Cursor c(data, data + size);
    c.set_begin(data);
    int64_t m = 0, nb = 0;
    if (!c.next_int(&m) || !c.next_int(&nb)) {
        snprintf(out->error, sizeof(out->error), "bad header");
        munmap((void*)data, size);
        return out;
    }
    out->m = m;
    out->n_blocks = nb;
    out->block_dims.resize(nb);
    for (int64_t i = 0; i < nb; ++i) {
        if (!c.next_int(&out->block_dims[i])) {
            snprintf(out->error, sizeof(out->error), "bad block dims");
            munmap((void*)data, size);
            return out;
        }
    }
    out->rhs.resize(m);
    for (int64_t i = 0; i < m; ++i) {
        if (!c.next_double(&out->rhs[i])) {
            snprintf(out->error, sizeof(out->error), "bad RHS");
            munmap((void*)data, size);
            return out;
        }
    }
    // entries until EOF
    size_t guess = size / 32 + 16;
    out->e_con.reserve(guess);
    out->e_blk.reserve(guess);
    out->e_row.reserve(guess);
    out->e_col.reserve(guess);
    out->e_val.reserve(guess);
    for (;;) {
        if (c.done()) break;
        int64_t con, blk, row, col;
        double val;
        if (!c.next_int(&con) || !c.next_int(&blk) || !c.next_int(&row) ||
            !c.next_int(&col) || !c.next_double(&val))
            break;
        out->e_con.push_back((int32_t)con);
        out->e_blk.push_back((int32_t)blk);
        out->e_row.push_back((int32_t)row);
        out->e_col.push_back((int32_t)col);
        out->e_val.push_back(val);
    }
    munmap((void*)data, size);
    return out;
}

const char* sdpa_error(void* h) { return ((Parsed*)h)->error; }
int64_t sdpa_m(void* h) { return ((Parsed*)h)->m; }
int64_t sdpa_n_blocks(void* h) { return ((Parsed*)h)->n_blocks; }
int64_t sdpa_n_entries(void* h) {
    return (int64_t)((Parsed*)h)->e_val.size();
}

void sdpa_copy_header(void* h, int64_t* dims, double* rhs) {
    auto* p = (Parsed*)h;
    memcpy(dims, p->block_dims.data(),
           p->block_dims.size() * sizeof(int64_t));
    memcpy(rhs, p->rhs.data(), p->rhs.size() * sizeof(double));
}

void sdpa_copy_entries(void* h, int32_t* con, int32_t* blk, int32_t* row,
                       int32_t* col, double* val) {
    auto* p = (Parsed*)h;
    size_t n = p->e_val.size();
    memcpy(con, p->e_con.data(), n * sizeof(int32_t));
    memcpy(blk, p->e_blk.data(), n * sizeof(int32_t));
    memcpy(row, p->e_row.data(), n * sizeof(int32_t));
    memcpy(col, p->e_col.data(), n * sizeof(int32_t));
    memcpy(val, p->e_val.data(), n * sizeof(double));
}

void sdpa_free(void* h) { delete (Parsed*)h; }

}  // extern "C"
