// Threaded stereo-frame prefetcher — the native runtime replacing the
// reference's reader_thread → condvar queue → slam_thread shell
// (`io/reader_thread.h:39-72`, `slam_thread.cpp:96-116`).
//
// N worker threads read + decode stereo pairs ahead of the consumer into a
// bounded ring of slots; the consumer drains IN ORDER (frame t must follow
// t-1 for temporal tracking), overlapping disk + decode with device compute.
//
// C ABI (ctypes):
//   zs_reader_create(paths_blob_l, paths_blob_r, n_frames, queue_cap, n_threads)
//     paths are '\n'-joined UTF-8 blobs
//   zs_reader_next(handle, out_left_f32, out_right_f32, w*h)  -> frame idx or <0
//   zs_reader_destroy(handle)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int zs_decode_png_gray(const uint8_t* data, size_t n, uint8_t** out,
                       int* w, int* h, int* bit_depth);
void zs_free(void* p);
}

namespace {

struct Slot {
    std::vector<float> left, right;
    int w = 0, h = 0;
    bool ready = false;
    int status = 0;
};

bool decode_to_float(const std::string& path, std::vector<float>& out, int* w, int* h) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long n = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(static_cast<size_t>(n), 0);
    size_t got = std::fread(buf.data(), 1, size_t(n), f);
    std::fclose(f);
    if (got != size_t(n)) return false;
    uint8_t* gray = nullptr;
    int bit_depth = 0;
    if (zs_decode_png_gray(buf.data(), buf.size(), &gray, w, h, &bit_depth) != 0)
        return false;
    const size_t npx = size_t(*w) * size_t(*h);
    out.resize(npx);
    if (bit_depth == 8) {
        const float s = 1.0f / 255.0f;
        for (size_t i = 0; i < npx; ++i) out[i] = gray[i] * s;
    } else {
        const float s = 1.0f / 65535.0f;
        const uint16_t* g16 = reinterpret_cast<const uint16_t*>(gray);
        for (size_t i = 0; i < npx; ++i) out[i] = g16[i] * s;
    }
    zs_free(gray);
    return true;
}

struct Reader {
    std::vector<std::string> left_paths, right_paths;
    std::vector<Slot> ring;
    size_t cap = 0;
    std::atomic<size_t> next_job{0};
    size_t next_consume = 0;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    std::vector<std::thread> workers;
    std::atomic<bool> stop{false};

    void worker() {
        while (!stop.load()) {
            size_t job = next_job.fetch_add(1);
            if (job >= left_paths.size()) return;
            Slot local;
            bool ok = decode_to_float(left_paths[job], local.left, &local.w, &local.h) &&
                      decode_to_float(right_paths[job], local.right, &local.w, &local.h);
            local.status = ok ? 0 : -1;
            std::unique_lock<std::mutex> lk(mu);
            // wait until the ring slot for this frame is free (bounded lookahead)
            cv_space.wait(lk, [&] {
                return stop.load() || job < next_consume + cap;
            });
            if (stop.load()) return;
            Slot& s = ring[job % cap];
            s = std::move(local);
            s.ready = true;
            cv_ready.notify_all();
        }
    }
};

}  // namespace

extern "C" {

void* zs_reader_create(const char* blob_l, const char* blob_r, int n_frames,
                       int queue_cap, int n_threads) {
    auto split = [](const char* blob, int n) {
        std::vector<std::string> out;
        const char* p = blob;
        for (int i = 0; i < n; ++i) {
            const char* e = std::strchr(p, '\n');
            if (!e) e = p + std::strlen(p);
            out.emplace_back(p, e);
            p = (*e) ? e + 1 : e;
        }
        return out;
    };
    auto* r = new Reader();
    r->left_paths = split(blob_l, n_frames);
    r->right_paths = split(blob_r, n_frames);
    r->cap = size_t(queue_cap > 0 ? queue_cap : 4);
    r->ring.resize(r->cap);
    for (int i = 0; i < (n_threads > 0 ? n_threads : 2); ++i)
        r->workers.emplace_back(&Reader::worker, r);
    return r;
}

// Copies frame `next_consume` into caller buffers; returns frame index,
// -1 on end of sequence, -2 on decode error, -3 on size mismatch.
int zs_reader_next(void* handle, float* out_left, float* out_right, int expect_px) {
    auto* r = static_cast<Reader*>(handle);
    if (r->next_consume >= r->left_paths.size()) return -1;
    size_t idx = r->next_consume;
    std::unique_lock<std::mutex> lk(r->mu);
    Slot& s = r->ring[idx % r->cap];
    r->cv_ready.wait(lk, [&] { return s.ready; });
    if (s.status != 0) return -2;
    if (int(s.left.size()) != expect_px) return -3;
    std::memcpy(out_left, s.left.data(), sizeof(float) * s.left.size());
    std::memcpy(out_right, s.right.data(), sizeof(float) * s.right.size());
    s.ready = false;
    r->next_consume = idx + 1;
    r->cv_space.notify_all();
    return int(idx);
}

void zs_reader_destroy(void* handle) {
    auto* r = static_cast<Reader*>(handle);
    r->stop.store(true);
    r->cv_space.notify_all();
    r->cv_ready.notify_all();
    for (auto& t : r->workers) t.join();
    delete r;
}

}  // extern "C"
