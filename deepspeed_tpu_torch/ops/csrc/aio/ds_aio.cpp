// Async file I/O engine for NVMe/SSD tensor swapping.
//
// Equivalent of the reference's libaio O_DIRECT engine
// (/root/reference/csrc/aio/common/deepspeed_aio_common.cpp:13-96,
// py_lib/deepspeed_py_aio_handle.cpp: handle with worker thread, pinned
// buffers, submit/wait).  Two engines behind one C ABI:
//
//  * UringEngine — kernel-async io_uring via raw syscalls
//    (io_uring_setup/io_uring_enter; this image has linux/io_uring.h but
//    no liburing).  Large transfers are split into block_size chunks
//    submitted concurrently on one ring, the in-kernel analogue of the
//    reference's io_submit block mode (deepspeed_aio_common.cpp:76-96).
//  * ThreadPoolEngine — std::thread pool issuing pread/pwrite; the
//    portable fallback when io_uring is unavailable (seccomp/container
//    policy), same overlap structure (submit returns, `wait` joins).
//
// O_DIRECT is honored per-op when buffer/offset/length meet the 4 KiB
// alignment contract, else that op silently degrades to buffered I/O
// (the caller opted in for bandwidth, not for EINVAL).
//
// C ABI for ctypes.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <errno.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/syscall.h>
#include <unistd.h>

#if defined(__linux__) && defined(__has_include)
#if __has_include(<linux/io_uring.h>)
#include <linux/io_uring.h>
#define DSTPU_HAVE_URING 1
#endif
#endif

namespace {

struct IoOp {
    bool write;
    void* buf;
    std::string path;
    int64_t nbytes;
    int64_t file_offset;
};

struct Engine {
    virtual void submit(IoOp op) = 0;
    virtual int64_t wait() = 0;  // join all pending; returns failed-op count
    virtual int kind() const = 0;  // 1 = thread pool, 2 = io_uring
    virtual ~Engine() = default;
};

constexpr int64_t kDirectAlign = 4096;

bool direct_ok(const void* buf, int64_t nbytes, int64_t off) {
    return (reinterpret_cast<uintptr_t>(buf) | static_cast<uint64_t>(nbytes) |
            static_cast<uint64_t>(off)) % kDirectAlign == 0;
}

int open_for(const IoOp& op, bool want_direct) {
    int flags = op.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
#ifdef O_DIRECT
    if (want_direct && direct_ok(op.buf, op.nbytes, op.file_offset))
        flags |= O_DIRECT;
#endif
    int fd = ::open(op.path.c_str(), flags, 0644);
#ifdef O_DIRECT
    if (fd < 0 && (flags & O_DIRECT)) {  // fs may not support O_DIRECT
        flags &= ~O_DIRECT;
        fd = ::open(op.path.c_str(), flags, 0644);
    }
#endif
    return fd;
}

// ---------------------------------------------------------------------------
// ThreadPoolEngine — pread/pwrite worker pool (fallback)
// ---------------------------------------------------------------------------

struct ThreadPoolEngine : Engine {
    std::vector<std::thread> workers;
    std::deque<IoOp> queue;
    std::mutex mu;
    std::condition_variable cv_submit;
    std::condition_variable cv_done;
    int64_t pending = 0;
    int64_t errors = 0;
    int block_size;
    bool use_o_direct;
    bool stop = false;

    explicit ThreadPoolEngine(int n_threads, int block, bool o_direct)
        : block_size(block > 0 ? block : (1 << 20)), use_o_direct(o_direct) {
        for (int i = 0; i < n_threads; ++i) {
            workers.emplace_back([this] { this->run(); });
        }
    }

    ~ThreadPoolEngine() override {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv_submit.notify_all();
        for (auto& t : workers) t.join();
    }

    void submit(IoOp op) override {
        {
            std::lock_guard<std::mutex> lk(mu);
            queue.push_back(std::move(op));
            ++pending;
        }
        cv_submit.notify_one();
    }

    int64_t wait() override {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [this] { return pending == 0; });
        int64_t e = errors;
        errors = 0;
        return e;
    }

    int kind() const override { return 1; }

    void run() {
        for (;;) {
            IoOp op;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_submit.wait(lk, [this] { return stop || !queue.empty(); });
                if (stop && queue.empty()) return;
                op = std::move(queue.front());
                queue.pop_front();
            }
            bool ok = execute(op);
            {
                std::lock_guard<std::mutex> lk(mu);
                if (!ok) ++errors;
                if (--pending == 0) cv_done.notify_all();
            }
        }
    }

    bool execute(const IoOp& op) {
        int fd = open_for(op, use_o_direct);
        if (fd < 0) return false;
        char* p = static_cast<char*>(op.buf);
        int64_t remaining = op.nbytes;
        int64_t off = op.file_offset;
        bool ok = true;
        while (remaining > 0) {
            int64_t chunk = remaining < block_size ? remaining : block_size;
            ssize_t r = op.write ? ::pwrite(fd, p, chunk, off)
                                 : ::pread(fd, p, chunk, off);
            if (r <= 0) {
                ok = false;
                break;
            }
            p += r;
            off += r;
            remaining -= r;
        }
        ::close(fd);
        return ok;
    }
};

#ifdef DSTPU_HAVE_URING

// ---------------------------------------------------------------------------
// UringEngine — raw-syscall io_uring
// ---------------------------------------------------------------------------

int sys_uring_setup(unsigned entries, io_uring_params* p) {
    return static_cast<int>(syscall(__NR_io_uring_setup, entries, p));
}

int sys_uring_enter(int fd, unsigned to_submit, unsigned min_complete,
                    unsigned flags) {
    return static_cast<int>(syscall(__NR_io_uring_enter, fd, to_submit,
                                    min_complete, flags, nullptr, 0));
}

struct UringEngine : Engine {
    // one submitted op fans out into block_size chunks concurrently in
    // flight on the ring; the op completes when every chunk has
    struct OpState {
        int fd = -1;
        bool write = false;
        int live_chunks = 0;
        bool failed = false;
    };
    struct Chunk {
        OpState* op;
        char* buf;
        int64_t nbytes;
        int64_t off;
    };

    int ring_fd = -1;
    unsigned sq_entry_count = 0;
    unsigned cq_entry_count = 0;
    unsigned* sq_head = nullptr;
    unsigned* sq_tail = nullptr;
    unsigned* sq_mask = nullptr;
    unsigned* sq_array = nullptr;
    unsigned* cq_head = nullptr;
    unsigned* cq_tail = nullptr;
    unsigned* cq_mask = nullptr;
    io_uring_sqe* sqes = nullptr;
    io_uring_cqe* cqes = nullptr;
    void* sq_ring_ptr = nullptr;
    void* cq_ring_ptr = nullptr;
    size_t sq_ring_sz = 0, cq_ring_sz = 0;
    bool single_mmap = false;

    std::mutex mu;
    std::deque<Chunk*> backlog;  // chunks waiting for a free SQE
    int64_t inflight = 0;        // SQEs the kernel has consumed, not reaped
    int64_t sq_credit = 0;       // SQEs published but not yet consumed by
                                 // io_uring_enter (partial/EINTR submits)
    int64_t open_ops = 0;        // ops not yet fully completed
    int64_t errors = 0;
    int block_size;
    bool use_o_direct;
    bool ok_ = false;

    explicit UringEngine(int depth, int block, bool o_direct)
        : block_size(block > 0 ? block : (1 << 20)), use_o_direct(o_direct) {
        io_uring_params p;
        std::memset(&p, 0, sizeof(p));
        unsigned entries = depth > 0 ? static_cast<unsigned>(depth) : 64;
        ring_fd = sys_uring_setup(entries, &p);
        if (ring_fd < 0) return;
        sq_entry_count = p.sq_entries;
        cq_entry_count = p.cq_entries;
        single_mmap = (p.features & IORING_FEAT_SINGLE_MMAP) != 0;
        sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(unsigned);
        cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(io_uring_cqe);
        if (single_mmap) {
            sq_ring_sz = cq_ring_sz = std::max(sq_ring_sz, cq_ring_sz);
        }
        sq_ring_ptr = ::mmap(nullptr, sq_ring_sz, PROT_READ | PROT_WRITE,
                             MAP_SHARED | MAP_POPULATE, ring_fd,
                             IORING_OFF_SQ_RING);
        if (sq_ring_ptr == MAP_FAILED) {
            sq_ring_ptr = nullptr;
            teardown();
            return;
        }
        if (single_mmap) {
            cq_ring_ptr = sq_ring_ptr;
        } else {
            cq_ring_ptr = ::mmap(nullptr, cq_ring_sz, PROT_READ | PROT_WRITE,
                                 MAP_SHARED | MAP_POPULATE, ring_fd,
                                 IORING_OFF_CQ_RING);
            if (cq_ring_ptr == MAP_FAILED) {
                cq_ring_ptr = nullptr;
                teardown();
                return;
            }
        }
        void* sq_mem = ::mmap(nullptr, p.sq_entries * sizeof(io_uring_sqe),
                              PROT_READ | PROT_WRITE,
                              MAP_SHARED | MAP_POPULATE, ring_fd,
                              IORING_OFF_SQES);
        if (sq_mem == MAP_FAILED) {
            teardown();
            return;
        }
        sqes = static_cast<io_uring_sqe*>(sq_mem);
        auto* sqb = static_cast<char*>(sq_ring_ptr);
        sq_head = reinterpret_cast<unsigned*>(sqb + p.sq_off.head);
        sq_tail = reinterpret_cast<unsigned*>(sqb + p.sq_off.tail);
        sq_mask = reinterpret_cast<unsigned*>(sqb + p.sq_off.ring_mask);
        sq_array = reinterpret_cast<unsigned*>(sqb + p.sq_off.array);
        auto* cqb = static_cast<char*>(cq_ring_ptr);
        cq_head = reinterpret_cast<unsigned*>(cqb + p.cq_off.head);
        cq_tail = reinterpret_cast<unsigned*>(cqb + p.cq_off.tail);
        cq_mask = reinterpret_cast<unsigned*>(cqb + p.cq_off.ring_mask);
        cqes = reinterpret_cast<io_uring_cqe*>(cqb + p.cq_off.cqes);
        ok_ = true;
    }

    void teardown() {
        if (sqes) ::munmap(sqes, sq_entry_count * sizeof(io_uring_sqe));
        if (cq_ring_ptr && cq_ring_ptr != sq_ring_ptr)
            ::munmap(cq_ring_ptr, cq_ring_sz);
        if (sq_ring_ptr) ::munmap(sq_ring_ptr, sq_ring_sz);
        if (ring_fd >= 0) ::close(ring_fd);
        sqes = nullptr;
        sq_ring_ptr = cq_ring_ptr = nullptr;
        ring_fd = -1;
    }

    ~UringEngine() override {
        if (ok_) {
            wait();  // never unmap under in-flight kernel DMA
            teardown();
        }
    }

    void submit(IoOp op) override {
        std::lock_guard<std::mutex> lk(mu);
        auto* st = new OpState();
        st->write = op.write;
        st->fd = open_for(op, use_o_direct);
        ++open_ops;
        if (st->fd < 0) {
            st->failed = true;
            complete_op(st);
            return;
        }
        if (op.nbytes == 0) {
            complete_op(st);
            return;
        }
        char* p = static_cast<char*>(op.buf);
        int64_t remaining = op.nbytes;
        int64_t off = op.file_offset;
        while (remaining > 0) {
            int64_t chunk = remaining < block_size ? remaining : block_size;
            ++st->live_chunks;
            backlog.push_back(new Chunk{st, p, chunk, off});
            p += chunk;
            off += chunk;
            remaining -= chunk;
        }
        pump(0);  // fill free SQEs now; completions reaped in wait()
    }

    int64_t wait() override {
        std::lock_guard<std::mutex> lk(mu);
        while (open_ops > 0) {
            if (!pump(inflight + sq_credit > 0 ? 1 : 0)) {
                // enter failed hard: fail everything still queued; chunks
                // already in the kernel drain through complete_op as their
                // CQEs arrive on later calls (ring stays mapped)
                for (auto* c : backlog) finish_chunk(c, false);
                backlog.clear();
                break;
            }
        }
        int64_t e = errors;
        errors = 0;
        return e;
    }

    // move backlog into free SQEs, enter(min_complete), reap CQEs.
    // Returns false only on an unrecoverable io_uring_enter error.
    bool pump(unsigned min_complete) {
        unsigned head = __atomic_load_n(sq_head, __ATOMIC_ACQUIRE);
        unsigned tail = *sq_tail;
        // cap outstanding work at the CQ size: kernels without
        // IORING_FEAT_NODROP drop overflowed CQEs and the op would never
        // complete (SQ slots free as soon as enter consumes them, so the
        // SQ-room check alone does not bound completions)
        while (!backlog.empty() && tail - head < sq_entry_count &&
               inflight + sq_credit < cq_entry_count) {
            Chunk* c = backlog.front();
            backlog.pop_front();
            unsigned idx = tail & *sq_mask;
            io_uring_sqe* sqe = &sqes[idx];
            std::memset(sqe, 0, sizeof(*sqe));
            sqe->opcode = c->op->write ? IORING_OP_WRITE : IORING_OP_READ;
            sqe->fd = c->op->fd;
            sqe->addr = reinterpret_cast<uint64_t>(c->buf);
            sqe->len = static_cast<unsigned>(c->nbytes);
            sqe->off = static_cast<uint64_t>(c->off);
            sqe->user_data = reinterpret_cast<uint64_t>(c);
            sq_array[idx] = idx;
            ++tail;
            ++sq_credit;
        }
        __atomic_store_n(sq_tail, tail, __ATOMIC_RELEASE);
        int r = sys_uring_enter(ring_fd,
                                static_cast<unsigned>(sq_credit),
                                min_complete,
                                min_complete ? IORING_ENTER_GETEVENTS : 0);
        if (r < 0) {
            // nothing consumed: sq_credit stays, published SQEs are
            // re-credited on the next enter
            if (errno == EINTR || errno == EAGAIN || errno == EBUSY) {
                reap();
                return true;
            }
            return false;
        }
        // r = SQEs the kernel actually consumed (may be < sq_credit)
        inflight += r;
        sq_credit -= r;
        reap();
        return true;
    }

    void reap() {
        unsigned head = *cq_head;
        unsigned tail = __atomic_load_n(cq_tail, __ATOMIC_ACQUIRE);
        while (head != tail) {
            io_uring_cqe* cqe = &cqes[head & *cq_mask];
            auto* c = reinterpret_cast<Chunk*>(
                static_cast<uintptr_t>(cqe->user_data));
            int32_t res = cqe->res;
            ++head;
            --inflight;
            if (res <= 0) {
                finish_chunk(c, false);
            } else if (res < c->nbytes) {
                // short transfer: continue where the kernel stopped
                c->buf += res;
                c->off += res;
                c->nbytes -= res;
                backlog.push_back(c);
            } else {
                finish_chunk(c, true);
            }
        }
        __atomic_store_n(cq_head, head, __ATOMIC_RELEASE);
    }

    void finish_chunk(Chunk* c, bool ok) {
        OpState* st = c->op;
        delete c;
        if (!ok) st->failed = true;
        if (--st->live_chunks <= 0) complete_op(st);
    }

    void complete_op(OpState* st) {
        if (st->fd >= 0) ::close(st->fd);
        if (st->failed) ++errors;
        delete st;
        --open_ops;
    }

    int kind() const override { return 2; }
};

#endif  // DSTPU_HAVE_URING

}  // namespace

extern "C" {

// 1 iff an io_uring ring can actually be created (header presence is not
// enough — container seccomp policies commonly block the syscalls).
int aio_uring_supported() {
#ifdef DSTPU_HAVE_URING
    io_uring_params p;
    std::memset(&p, 0, sizeof(p));
    int fd = sys_uring_setup(4, &p);
    if (fd < 0) return 0;
    ::close(fd);
    return 1;
#else
    return 0;
#endif
}

// engine: 1 = thread pool, 2 = io_uring (NULL if unavailable),
//         0 = auto (io_uring when supported, else thread pool).
// n is the worker count (threads) or the SQ depth (io_uring).
void* aio_handle_create2(int n, int block_size, int o_direct, int engine) {
#ifdef DSTPU_HAVE_URING
    if (engine == 2 || engine == 0) {
        // the ring depth wants headroom beyond a thread-count-scale n;
        // bumped HERE so an auto fallback still gets n threads, not 64
        int depth = n < 64 ? 64 : n;
        auto* u = new UringEngine(depth, block_size, o_direct != 0);
        if (u->ok_) return static_cast<Engine*>(u);
        delete u;
        if (engine == 2) return nullptr;
    }
#else
    if (engine == 2) return nullptr;
#endif
    return static_cast<Engine*>(
        new ThreadPoolEngine(n > 0 ? n : 1, block_size, o_direct != 0));
}

// 1 = thread pool, 2 = io_uring — what the handle ACTUALLY is (auto may
// have fallen back after a setup/mmap failure).
int aio_handle_engine(void* h) {
    return static_cast<Engine*>(h)->kind();
}

void* aio_handle_create(int n_threads, int block_size, int o_direct) {
    if (n_threads <= 0) n_threads = 1;
    return static_cast<Engine*>(
        new ThreadPoolEngine(n_threads, block_size, o_direct != 0));
}

void aio_handle_destroy(void* h) {
    delete static_cast<Engine*>(h);
}

// async=0 blocks until THIS op (and all prior pending) completes.
int aio_pwrite(void* h, const void* buf, const char* path, int64_t nbytes,
               int64_t file_offset, int async_mode) {
    auto* e = static_cast<Engine*>(h);
    e->submit(IoOp{true, const_cast<void*>(buf), path, nbytes, file_offset});
    if (!async_mode) return static_cast<int>(e->wait());
    return 0;
}

int aio_pread(void* h, void* buf, const char* path, int64_t nbytes,
              int64_t file_offset, int async_mode) {
    auto* e = static_cast<Engine*>(h);
    e->submit(IoOp{false, buf, path, nbytes, file_offset});
    if (!async_mode) return static_cast<int>(e->wait());
    return 0;
}

// wait for all pending ops; returns number of failed ops (0 = success).
int aio_wait(void* h) {
    return static_cast<int>(static_cast<Engine*>(h)->wait());
}

}  // extern "C"
