// Native shard loader: multi-threaded, order-preserving read-ahead pipeline.
//
// The reference's input path (load_new_batch, resnet.cu:1235-1325) freads an
// entire multi-GB shard into RAM synchronously on the training thread, then
// memcpys batch slices — its own comment (resnet.cu:1233) concedes this
// should have been overlapped. This loader is the native host-side
// equivalent done right:
//
//   * N worker threads pread() batch-sized slices straight from the shard
//     files (no whole-shard staging buffer); each takes a sequence ticket
//     and completed batches are resequenced so the consumer always sees
//     ticket order regardless of disk completion order,
//   * a bounded window of outstanding tickets decouples disk from the
//     training thread and caps memory at ~depth batches,
//   * optional NCHW->NHWC repack on the worker threads (the transform the
//     shard builder bakes in, build_training_shards.c:133-147, inverted
//     for the channels-last layout the model runs in),
//   * shard-cursor semantics identical to the Python ShardIterator
//     (shard, batch_in_shard, epoch) so checkpoints resume exactly;
//     truncated final shards are clamped to the batches actually on disk
//     (like the Python path's open_shard n_avail), not hard errors.
//
// C ABI (driven from Python via ctypes, resnet_tpu/data/native.py):
//   loader_create / loader_next / loader_error / loader_destroy
//
// Shard file format: %03d.images raw float32, %03d.labels raw int32
// (build_training_shards.c:148-160).

#include <atomic>
#include <memory>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Cursor {
  int64_t shard = 0;
  int64_t batch_in_shard = 0;
  int64_t epoch = 0;
};

struct Batch {
  // raw arrays, not vectors: new[] skips the value-initialization that
  // would add a full zero-fill memory pass per 150MB batch
  std::unique_ptr<float[]> images;
  std::unique_ptr<int32_t[]> labels;
  Cursor cursor;  // cursor value *after* this batch is consumed
};

struct Loader {
  std::string dir;
  int num_shards;
  int shard_images;
  int image_dim;
  int channels;
  int batch_size;
  bool disk_nchw;   // on-disk layout
  bool out_nhwc;    // output layout
  int prefetch_depth;

  int64_t image_size;  // floats per image
  int max_batches_per_shard;

  // ---- producer ticketing (guarded by mu) ----
  Cursor read_cursor;          // cursor of the NEXT batch to claim
  int64_t next_ticket = 0;     // sequence number handed to workers
  int64_t next_emit = 0;       // sequence number the consumer wants next
  // actual batch count per shard, clamped to the file size on disk;
  // -1 = not yet stat'ed (lazy, guarded by mu)
  std::vector<int> shard_batches;

  // resequencing buffer: ticket -> completed batch
  std::map<int64_t, Batch*> ready;
  // recycled batch buffers: reuse avoids a fresh 150MB mmap + zero-page
  // fault storm per batch (measured ~2x of loader throughput)
  std::vector<Batch*> pool;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};
  std::string error;

  ~Loader() {
    stop.store(true);
    cv_space.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    for (auto& kv : ready) delete kv.second;
    for (auto* b : pool) delete b;
  }

  Batch* take_batch(int64_t batch_floats) {
    {
      std::lock_guard<std::mutex> lk(mu);
      if (!pool.empty()) {
        Batch* b = pool.back();
        pool.pop_back();
        return b;
      }
    }
    auto* b = new Batch;
    b->images.reset(new float[batch_floats]);
    b->labels.reset(new int32_t[batch_size]);
    return b;
  }

  void recycle_batch(Batch* b) {
    std::lock_guard<std::mutex> lk(mu);
    if (static_cast<int>(pool.size()) < prefetch_depth + 2) {
      pool.push_back(b);
    } else {
      delete b;
    }
  }
};

// Batches actually present in a shard file: min(configured, on-disk size).
// A short final shard yields fewer batches (the remainder is dropped, same
// as the Python iterator); a missing file reports -2.
int stat_shard_batches(Loader* L, int64_t shard) {
  char ipath[4096];
  snprintf(ipath, sizeof ipath, "%s/%03lld.images", L->dir.c_str(),
           static_cast<long long>(shard));
  struct stat st;
  if (stat(ipath, &st) != 0) return -2;
  int64_t n_avail = st.st_size / (L->image_size * sizeof(float));
  int64_t batches = n_avail / L->batch_size;
  if (batches > L->max_batches_per_shard) batches = L->max_batches_per_shard;
  return static_cast<int>(batches);
}

// Requires L->mu held. Returns batches in this shard, -2 on missing file,
// or -3 on an out-of-range shard index (e.g. a resume cursor from a
// stale/hand-edited checkpoint — indexing shard_batches[] with it would
// be UB, so it gets the same clean-error treatment as a missing file).
int batches_in_shard_locked(Loader* L, int64_t shard) {
  if (shard < 0 || shard >= static_cast<int64_t>(L->shard_batches.size()))
    return -3;
  int& cached = L->shard_batches[shard];
  if (cached == -1) cached = stat_shard_batches(L, shard);
  return cached;
}

// Requires L->mu held. Moves c to the next readable position, skipping
// empty/short-tail shards; false if no shard in the epoch has a full batch
// or a shard file is missing.
bool normalize_cursor_locked(Loader* L, Cursor* c, std::string* err) {
  for (int hops = 0; hops <= L->num_shards; ++hops) {
    int nb = batches_in_shard_locked(L, c->shard);
    if (nb == -3) {
      *err = "shard cursor out of range: shard " +
             std::to_string(c->shard) + " of " +
             std::to_string(L->num_shards);
      return false;
    }
    if (nb == -2) {
      char ipath[4096];
      snprintf(ipath, sizeof ipath, "%s/%03lld.images", L->dir.c_str(),
               static_cast<long long>(c->shard));
      *err = std::string("missing shard file ") + ipath;
      return false;
    }
    if (c->batch_in_shard < nb) return true;
    c->batch_in_shard = 0;
    c->shard++;
    if (c->shard >= L->num_shards) {
      c->shard = 0;
      c->epoch++;
    }
  }
  *err = "no shard contains a full batch";
  return false;
}

bool read_exact(int fd, void* dst, size_t n, off_t off) {
  char* p = static_cast<char*>(dst);
  while (n > 0) {
    ssize_t r = pread(fd, p, n, off);
    if (r <= 0) return false;
    p += r;
    off += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

// NCHW (C,H,W per image) -> NHWC repack of one image.
void repack_chw_to_hwc(const float* src, float* dst, int c, int h, int w) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  if (c == 3) {
    // RGB fast path: one pass with fully sequential writes (the generic
    // loop writes stride-c floats c times over, defeating write-combining)
    const float* r = src;
    const float* g = src + hw;
    const float* b = src + 2 * hw;
    for (int64_t i = 0; i < hw; ++i) {
      dst[3 * i] = r[i];
      dst[3 * i + 1] = g[i];
      dst[3 * i + 2] = b[i];
    }
    return;
  }
  for (int ch = 0; ch < c; ++ch) {
    const float* s = src + static_cast<int64_t>(ch) * hw;
    float* d = dst + ch;
    for (int64_t i = 0; i < hw; ++i) {
      d[i * c] = s[i];
    }
  }
}

void fail(Loader* L, const std::string& msg) {
  std::lock_guard<std::mutex> lk(L->mu);
  if (L->error.empty()) L->error = msg;
  L->stop.store(true);
  L->cv_ready.notify_all();
  L->cv_space.notify_all();
}

void worker_main(Loader* L) {
  const int64_t img_floats = L->image_size;
  const int64_t batch_floats = img_floats * L->batch_size;
  std::vector<float> staging;
  const bool need_repack = L->disk_nchw && L->out_nhwc;
  if (need_repack) staging.resize(batch_floats);

  while (true) {
    // claim a ticket + cursor position inside the bounded window
    int64_t seq;
    Cursor my;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_space.wait(lk, [L] {
        return L->stop.load() ||
               L->next_ticket - L->next_emit < L->prefetch_depth;
      });
      if (L->stop.load()) return;
      std::string err;
      if (!normalize_cursor_locked(L, &L->read_cursor, &err)) {
        lk.unlock();
        fail(L, err);
        return;
      }
      seq = L->next_ticket++;
      my = L->read_cursor;
      L->read_cursor.batch_in_shard++;  // normalized lazily on next claim
    }

    Batch* b = L->take_batch(batch_floats);

    char ipath[4096], lpath[4096];
    snprintf(ipath, sizeof ipath, "%s/%03lld.images", L->dir.c_str(),
             static_cast<long long>(my.shard));
    snprintf(lpath, sizeof lpath, "%s/%03lld.labels", L->dir.c_str(),
             static_cast<long long>(my.shard));

    int ifd = open(ipath, O_RDONLY);
    int lfd = open(lpath, O_RDONLY);
    bool ok = ifd >= 0 && lfd >= 0;
    if (ok) {
      off_t ioff = static_cast<off_t>(my.batch_in_shard) * batch_floats *
                   sizeof(float);
      off_t loff = static_cast<off_t>(my.batch_in_shard) * L->batch_size *
                   sizeof(int32_t);
      float* img_dst = need_repack ? staging.data() : b->images.get();
      ok = read_exact(ifd, img_dst, batch_floats * sizeof(float), ioff) &&
           read_exact(lfd, b->labels.get(), L->batch_size * sizeof(int32_t),
                      loff);
      if (ok && need_repack) {
        for (int i = 0; i < L->batch_size; ++i) {
          repack_chw_to_hwc(staging.data() + i * img_floats,
                            b->images.get() + i * img_floats, L->channels,
                            L->image_dim, L->image_dim);
        }
      }
    }
    if (ifd >= 0) close(ifd);
    if (lfd >= 0) close(lfd);

    if (!ok) {
      delete b;
      fail(L, std::string("failed reading ") + ipath);
      return;
    }

    // post-batch cursor (what a checkpoint taken after this batch records)
    Cursor after = my;
    after.batch_in_shard++;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      std::string err;
      if (!normalize_cursor_locked(L, &after, &err)) {
        // tail position is still a valid resume point; leave un-normalized
      }
      b->cursor = after;
      // resequence: the map keeps ticket order however workers finish
      L->ready.emplace(seq, b);
      if (seq == L->next_emit) L->cv_ready.notify_all();
      if (L->stop.load()) return;
    }
  }
}

}  // namespace

extern "C" {

void* loader_create(const char* dir, int num_shards, int shard_images,
                    int image_dim, int channels, int batch_size,
                    int disk_nchw, int out_nhwc, int prefetch_depth,
                    int64_t start_shard, int64_t start_batch,
                    int64_t start_epoch, int num_workers) {
  auto* L = new Loader;
  L->dir = dir;
  L->num_shards = num_shards;
  L->shard_images = shard_images;
  L->image_dim = image_dim;
  L->channels = channels;
  L->batch_size = batch_size;
  L->disk_nchw = disk_nchw != 0;
  L->out_nhwc = out_nhwc != 0;
  L->prefetch_depth = prefetch_depth > 0 ? prefetch_depth : 4;
  L->image_size = static_cast<int64_t>(image_dim) * image_dim * channels;
  L->max_batches_per_shard = shard_images / batch_size;
  L->read_cursor = {start_shard, start_batch, start_epoch};
  L->shard_batches.assign(num_shards, -1);
  if (num_workers <= 0) {
    // conservative default: reads are page-cache/memory-bandwidth bound on
    // typical hosts and extra workers mostly contend (measured); deeper
    // parallelism is opt-in via the num_workers arg
    unsigned hc = std::thread::hardware_concurrency();
    num_workers = hc >= 2 ? 2 : 1;
  }
  if (num_workers > L->prefetch_depth) num_workers = L->prefetch_depth;
  for (int i = 0; i < num_workers; ++i) L->workers.emplace_back(worker_main, L);
  return L;
}

// Copies the next batch into caller-provided buffers. Returns 0 on success,
// 1 on error (see loader_error). Writes the post-batch cursor into
// cursor_out[3] = {shard, batch_in_shard, epoch}.
int loader_next(void* handle, float* images_out, int32_t* labels_out,
                int64_t* cursor_out) {
  auto* L = static_cast<Loader*>(handle);
  Batch* b = nullptr;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [L] {
      return L->stop.load() || L->ready.count(L->next_emit) > 0;
    });
    auto it = L->ready.find(L->next_emit);
    if (it == L->ready.end()) return 1;  // stopped on error
    b = it->second;
    L->ready.erase(it);
    L->next_emit++;
    L->cv_space.notify_all();
  }
  memcpy(images_out, b->images.get(),
         static_cast<size_t>(L->image_size) * L->batch_size * sizeof(float));
  memcpy(labels_out, b->labels.get(), L->batch_size * sizeof(int32_t));
  if (cursor_out) {
    cursor_out[0] = b->cursor.shard;
    cursor_out[1] = b->cursor.batch_in_shard;
    cursor_out[2] = b->cursor.epoch;
  }
  L->recycle_batch(b);
  return 0;
}

const char* loader_error(void* handle) {
  return static_cast<Loader*>(handle)->error.c_str();
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
