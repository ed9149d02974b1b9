// Native small-read plan executor.
//
// choose_route() stays in Python as the planner; this file is the
// engine. The client packs a plan — one 48-byte POD record per op —
// and hands the whole table across the ctypes boundary in ONE call, so
// the GIL is released exactly once per batch instead of once per op.
// Each op is either a memcpy from an already-mapped source (SHM
// segment, received read_many payload, stripe scratch) or a pread(2)
// from a local file descriptor, landing in a single preallocated
// destination buffer at the planned offset. Zero per-op Python frames;
// the per-op cost drops from interpreter-dispatch time to memory
// bandwidth.
//
// Failure contract: the executor validates every op's bounds before
// touching memory for it and returns -(i+1) on the first bad op i
// (unknown kind, source/dest overrun, pread error or short read).
// Bytes already written for earlier ops stay written — the Python
// caller discards the buffer and falls down the route ladder to the
// pure-Python path, which is byte-identical by construction.
//
// Loaded via ctypes, so the entry point is extern "C" with POD-only
// arguments; the record layout below is naturally aligned (4+4+8*5 =
// 48 bytes, no padding) and mirrored by OP_DTYPE in __init__.py.

#include <cerrno>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <unistd.h>

namespace {

enum : uint32_t {
    kOpCopy = 0,   // memcpy(dst + dst_off, src + src_off, len)
    kOpPread = 1,  // pread(fd, dst + dst_off, len, src_off)
};

struct AtpuPlanOp {
    uint32_t kind;
    int32_t fd;        // kOpPread only; -1 otherwise
    uint64_t src;      // kOpCopy: source base address
    uint64_t src_off;  // offset within source (kOpCopy) / file (kOpPread)
    uint64_t src_len;  // kOpCopy: source extent for bounds checking
    uint64_t dst_off;  // offset within the destination buffer
    uint64_t len;      // bytes to move; 0 is a valid no-op
};

static_assert(sizeof(AtpuPlanOp) == 48, "op record layout drifted");

// Full read at an absolute offset: pread may return short on signals
// or page-cache boundaries; anything short of len after EOF is an
// error (the planner clamped sizes to the readable extent already).
bool pread_full(int fd, uint8_t* dst, uint64_t len, uint64_t off) {
    while (len > 0) {
        ssize_t got = ::pread(fd, dst, static_cast<size_t>(len),
                              static_cast<off_t>(off));
        if (got < 0) {
            if (errno == EINTR) continue;
            return false;
        }
        if (got == 0) return false;  // EOF before the planned extent
        dst += got;
        off += static_cast<uint64_t>(got);
        len -= static_cast<uint64_t>(got);
    }
    return true;
}

}  // namespace

extern "C" {

// Execute nops plan records into dst[0:dst_len]. Returns the total
// bytes written (>= 0) on success, or -(i+1) when op i fails
// validation or I/O. Ops may overlap in the destination (last writer
// wins, in table order) — the Python reference executor matches.
int64_t atpu_plan_exec(const AtpuPlanOp* ops, size_t nops,
                       uint8_t* dst, size_t dst_len) {
    int64_t total = 0;
    for (size_t i = 0; i < nops; ++i) {
        const AtpuPlanOp& op = ops[i];
        if (op.len == 0) continue;
        if (op.dst_off > dst_len || op.len > dst_len - op.dst_off)
            return -static_cast<int64_t>(i + 1);
        uint8_t* out = dst + op.dst_off;
        switch (op.kind) {
            case kOpCopy: {
                if (op.src == 0 || op.src_off > op.src_len ||
                    op.len > op.src_len - op.src_off)
                    return -static_cast<int64_t>(i + 1);
                std::memcpy(out,
                            reinterpret_cast<const uint8_t*>(op.src) +
                                op.src_off,
                            static_cast<size_t>(op.len));
                break;
            }
            case kOpPread: {
                if (op.fd < 0 ||
                    !pread_full(op.fd, out, op.len, op.src_off))
                    return -static_cast<int64_t>(i + 1);
                break;
            }
            default:
                return -static_cast<int64_t>(i + 1);
        }
        total += static_cast<int64_t>(op.len);
    }
    return total;
}

}  // extern "C"
