// nnstpu: native runtime support for nnstreamer_tpu_torch, the JAX
// package's nnstreamer_tpu/native/src/nnstpu.cpp copied unchanged below
// this header (the port keeps its own copy of every source it builds).
//
// Reference analogs (upstream-reconstructed, SURVEY §2.7/§2.2):
//   * nnstreamer-edge — the C transport library carrying other/tensors
//     frames between processes/hosts (framing + integrity);
//   * GStreamer's shmsrc/shmsink + GstBufferPool — zero-copy same-host
//     hand-off between pipelines via a shared-memory ring;
//   * gsttensor_converter.c's row-stride repack — the per-frame host hot
//     loop before tensors reach the device.
//
// The TPU build keeps orchestration in Python but puts these per-byte hot
// paths in C++ behind a small C ABI (ctypes-friendly; no pybind11 in this
// environment).  Everything is single-file on purpose: one .so, no deps
// beyond libc/librt.

#include <atomic>
#include <mutex>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>

#include <errno.h>
#include <fcntl.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32 (IEEE, table-driven) — wire-frame integrity on DCN transports.
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[8][256];
static std::once_flag g_crc_once;  // ctypes calls drop the GIL: real races

static void crc32_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (-(int32_t)(c & 1)));
    g_crc_table[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++)
    for (int s = 1; s < 8; s++)
      g_crc_table[s][i] =
          (g_crc_table[s - 1][i] >> 8) ^ g_crc_table[0][g_crc_table[s - 1][i] & 0xff];
}

uint32_t nns_crc32(const uint8_t *data, uint64_t len, uint32_t seed) {
  std::call_once(g_crc_once, crc32_init);
  uint32_t c = ~seed;
  // slice-by-8
  while (len >= 8) {
    c ^= *(const uint32_t *)data;
    uint32_t hi = *(const uint32_t *)(data + 4);
    c = g_crc_table[7][c & 0xff] ^ g_crc_table[6][(c >> 8) & 0xff] ^
        g_crc_table[5][(c >> 16) & 0xff] ^ g_crc_table[4][c >> 24] ^
        g_crc_table[3][hi & 0xff] ^ g_crc_table[2][(hi >> 8) & 0xff] ^
        g_crc_table[1][(hi >> 16) & 0xff] ^ g_crc_table[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) c = g_crc_table[0][(c ^ *data++) & 0xff] ^ (c >> 8);
  return ~c;
}

// ---------------------------------------------------------------------------
// Stride repack: drop per-row padding (video rowstride != width*bpp).
// src rows of src_stride bytes -> dst rows of row_bytes, for h rows of
// depth planes (plane_stride covers planar layouts; 0 = packed single plane).
// ---------------------------------------------------------------------------

void nns_strip_stride(const uint8_t *src, uint8_t *dst, uint64_t rows,
                      uint64_t row_bytes, uint64_t src_stride) {
  if (src_stride == row_bytes) {
    memcpy(dst, src, rows * row_bytes);
    return;
  }
  for (uint64_t r = 0; r < rows; r++)
    memcpy(dst + r * row_bytes, src + r * src_stride, row_bytes);
}

// ---------------------------------------------------------------------------
// Wire assembly: gather N segments into one contiguous frame with a
// length prefix and trailing crc32.  (The Python codec builds the segments;
// the native path does the single-copy gather + checksum in C.)
// layout: u64 payload_len | payload | u32 crc32(payload)
// ---------------------------------------------------------------------------

uint64_t nns_wire_frame_size(const uint64_t *seg_lens, uint32_t nsegs) {
  uint64_t total = 8 + 4;
  for (uint32_t i = 0; i < nsegs; i++) total += seg_lens[i];
  return total;
}

void nns_wire_gather(const uint8_t *const *segs, const uint64_t *seg_lens,
                     uint32_t nsegs, uint8_t *out) {
  uint64_t payload = 0;
  for (uint32_t i = 0; i < nsegs; i++) payload += seg_lens[i];
  memcpy(out, &payload, 8);
  uint8_t *p = out + 8;
  for (uint32_t i = 0; i < nsegs; i++) {
    memcpy(p, segs[i], seg_lens[i]);
    p += seg_lens[i];
  }
  uint32_t crc = nns_crc32(out + 8, payload, 0);
  memcpy(p, &crc, 4);
}

// Verify a received frame payload against its trailing crc. 1 = ok.
int nns_wire_check(const uint8_t *payload, uint64_t len, uint32_t crc) {
  return nns_crc32(payload, len, 0) == crc ? 1 : 0;
}

// ---------------------------------------------------------------------------
// SPSC shared-memory ring — same-host zero-copy pipeline hand-off
// (GStreamer shmsink/shmsrc analog).  Fixed slot size, single producer,
// single consumer, lock-free via acquire/release atomics on head/tail.
//
// Shm layout: Header | slot_lens[nslots] (u64) | slots (nslots*slot_bytes)
// ---------------------------------------------------------------------------

struct RingHeader {
  std::atomic<uint32_t> magic;  // 'NSRG'; stored LAST (release) at create
  uint32_t nslots;
  uint64_t slot_bytes;
  uint64_t owner_pid;          // producer pid, for stale-ring detection
  std::atomic<uint64_t> head;  // next slot to write (producer)
  std::atomic<uint64_t> tail;  // next slot to read (consumer)
  std::atomic<uint32_t> closed;
};

static const uint32_t RING_MAGIC = 0x4E535247u;

struct Ring {
  RingHeader *hdr;
  uint64_t *lens;
  uint8_t *slots;
  uint64_t map_bytes;
  int fd;
  char name[256];
  int owner;
};

static uint64_t ring_bytes(uint32_t nslots, uint64_t slot_bytes) {
  return sizeof(RingHeader) + nslots * sizeof(uint64_t) + (uint64_t)nslots * slot_bytes;
}

// Is the ring at `name` owned by a live process?  0 = dead/invalid (safe to
// unlink), 1 = live, -1 = can't tell.
static int ring_owner_alive(const char *name) {
  int fd = shm_open(name, O_RDONLY, 0600);
  if (fd < 0) return 0;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(RingHeader)) {
    close(fd);
    return 0;
  }
  void *mem = mmap(nullptr, sizeof(RingHeader), PROT_READ, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return -1;
  RingHeader *h = (RingHeader *)mem;
  int alive = 0;
  if (h->magic.load(std::memory_order_acquire) == RING_MAGIC && h->owner_pid > 0)
    alive = (kill((pid_t)h->owner_pid, 0) == 0 || errno == EPERM) ? 1 : 0;
  munmap(mem, sizeof(RingHeader));
  return alive;
}

void *nns_ring_create(const char *name, uint32_t nslots, uint64_t slot_bytes) {
  int fd = shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600);
  if (fd < 0 && errno == EEXIST) {
    // Only reclaim a ring whose owning producer is demonstrably gone —
    // unlinking a live producer's ring would silently fork the stream.
    if (ring_owner_alive(name) != 0) return nullptr;
    shm_unlink(name);
    fd = shm_open(name, O_CREAT | O_RDWR | O_EXCL, 0600);
  }
  if (fd < 0) return nullptr;
  uint64_t total = ring_bytes(nslots, slot_bytes);
  if (ftruncate(fd, (off_t)total) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void *mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  Ring *r = new Ring();
  r->hdr = (RingHeader *)mem;
  r->hdr->nslots = nslots;
  r->hdr->slot_bytes = slot_bytes;
  r->hdr->owner_pid = (uint64_t)getpid();
  r->hdr->head.store(0);
  r->hdr->tail.store(0);
  r->hdr->closed.store(0);
  // Publish last: a concurrent nns_ring_open polling this mapping must not
  // see the magic before the geometry fields are valid.
  r->hdr->magic.store(RING_MAGIC, std::memory_order_release);
  r->lens = (uint64_t *)((uint8_t *)mem + sizeof(RingHeader));
  r->slots = (uint8_t *)(r->lens + nslots);
  r->map_bytes = total;
  r->fd = fd;
  snprintf(r->name, sizeof(r->name), "%s", name);
  r->owner = 1;
  return r;
}

void *nns_ring_open(const char *name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (uint64_t)st.st_size < sizeof(RingHeader)) {
    close(fd);
    return nullptr;
  }
  void *mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    close(fd);
    return nullptr;
  }
  RingHeader *h = (RingHeader *)mem;
  if (h->magic.load(std::memory_order_acquire) != RING_MAGIC ||
      (uint64_t)st.st_size < ring_bytes(h->nslots, h->slot_bytes)) {
    munmap(mem, (size_t)st.st_size);
    close(fd);
    return nullptr;
  }
  Ring *r = new Ring();
  r->hdr = h;
  r->lens = (uint64_t *)((uint8_t *)mem + sizeof(RingHeader));
  r->slots = (uint8_t *)(r->lens + h->nslots);
  r->map_bytes = (uint64_t)st.st_size;
  r->fd = fd;
  snprintf(r->name, sizeof(r->name), "%s", name);
  r->owner = 0;
  return r;
}

uint64_t nns_ring_slot_bytes(void *ring) { return ((Ring *)ring)->hdr->slot_bytes; }
uint32_t nns_ring_nslots(void *ring) { return ((Ring *)ring)->hdr->nslots; }

// Producer: returns slot pointer to write into, or NULL when full/closed.
uint8_t *nns_ring_acquire(void *ring) {
  Ring *r = (Ring *)ring;
  if (r->hdr->closed.load(std::memory_order_acquire)) return nullptr;
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  uint64_t tail = r->hdr->tail.load(std::memory_order_acquire);
  if (head - tail >= r->hdr->nslots) return nullptr;  // full
  return r->slots + (head % r->hdr->nslots) * r->hdr->slot_bytes;
}

// Producer: publish the acquired slot with `len` valid bytes. 1 = ok.
int nns_ring_commit(void *ring, uint64_t len) {
  Ring *r = (Ring *)ring;
  if (len > r->hdr->slot_bytes) return 0;
  uint64_t head = r->hdr->head.load(std::memory_order_relaxed);
  r->lens[head % r->hdr->nslots] = len;
  r->hdr->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Consumer: returns pointer to the next filled slot (sets *len), or NULL
// when empty.  Call nns_ring_release after copying/consuming.
const uint8_t *nns_ring_peek(void *ring, uint64_t *len) {
  Ring *r = (Ring *)ring;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  uint64_t head = r->hdr->head.load(std::memory_order_acquire);
  if (tail == head) return nullptr;  // empty
  *len = r->lens[tail % r->hdr->nslots];
  return r->slots + (tail % r->hdr->nslots) * r->hdr->slot_bytes;
}

void nns_ring_release(void *ring) {
  Ring *r = (Ring *)ring;
  uint64_t tail = r->hdr->tail.load(std::memory_order_relaxed);
  r->hdr->tail.store(tail + 1, std::memory_order_release);
}

int nns_ring_closed(void *ring) {
  return (int)((Ring *)ring)->hdr->closed.load(std::memory_order_acquire);
}

void nns_ring_close(void *ring) {
  ((Ring *)ring)->hdr->closed.store(1, std::memory_order_release);
}

void nns_ring_free(void *ring) {
  Ring *r = (Ring *)ring;
  munmap((void *)r->hdr, r->map_bytes);
  close(r->fd);
  if (r->owner) shm_unlink(r->name);
  delete r;
}

// ---------------------------------------------------------------------------
// v4l2 capture (ioctl + mmap buffer ring) — the literal camera ingest hot
// path (reference analog: v4l2src feeding tensor_converter; SURVEY §7's
// "v4l2src -> tensor_filter" north star).  Streaming I/O: REQBUFS(MMAP),
// QBUF all, STREAMON; each nns_v4l2_capture select()s with a timeout,
// DQBUFs one filled buffer, copies the payload out, and immediately QBUFs
// the slot back — the driver always owns n-1 buffers, so frame drops under
// a slow consumer happen in the DRIVER ring (newest-overwrites policy per
// driver), never by unbounded host queueing.
// ---------------------------------------------------------------------------

}  // extern "C"

#include <linux/videodev2.h>
#include <sys/ioctl.h>
#include <sys/select.h>

namespace {

struct V4l2Cap {
  int fd = -1;
  uint32_t n_bufs = 0;
  void *maps[16] = {nullptr};
  size_t lens[16] = {0};
  uint32_t frame_bytes = 0;
  uint32_t stride = 0;  // bytesperline: drivers may pad rows
};

static int xioctl(int fd, unsigned long req, void *arg) {
  int r;
  do {
    r = ioctl(fd, req, arg);
  } while (r == -1 && errno == EINTR);
  return r;
}

static void set_err(char *err, int errlen, const char *msg) {
  if (err && errlen > 0) {
    snprintf(err, (size_t)errlen, "%s (errno %d)", msg, errno);
  }
}

}  // namespace

extern "C" {

void nns_v4l2_close(void *handle);  // used by open's error paths

// Negotiates *width/*height/*fourcc with the driver (values updated to
// what the device actually delivers); returns an opaque handle or null
// with `err` filled.
void *nns_v4l2_open(const char *dev, int *width, int *height,
                    uint32_t *fourcc, int n_bufs, char *err, int errlen) {
  int fd = open(dev, O_RDWR | O_NONBLOCK);
  if (fd < 0) {
    set_err(err, errlen, "open failed");
    return nullptr;
  }
  v4l2_capability cap;
  memset(&cap, 0, sizeof(cap));
  if (xioctl(fd, VIDIOC_QUERYCAP, &cap) < 0) {
    set_err(err, errlen, "VIDIOC_QUERYCAP failed (not a v4l2 device?)");
    close(fd);
    return nullptr;
  }
  if (!(cap.capabilities & V4L2_CAP_VIDEO_CAPTURE) ||
      !(cap.capabilities & V4L2_CAP_STREAMING)) {
    set_err(err, errlen, "device lacks CAPTURE+STREAMING capabilities");
    close(fd);
    return nullptr;
  }
  v4l2_format fmt;
  memset(&fmt, 0, sizeof(fmt));
  fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  fmt.fmt.pix.width = (uint32_t)*width;
  fmt.fmt.pix.height = (uint32_t)*height;
  fmt.fmt.pix.pixelformat = *fourcc;
  fmt.fmt.pix.field = V4L2_FIELD_NONE;
  if (xioctl(fd, VIDIOC_S_FMT, &fmt) < 0) {
    set_err(err, errlen, "VIDIOC_S_FMT failed");
    close(fd);
    return nullptr;
  }
  *width = (int)fmt.fmt.pix.width;
  *height = (int)fmt.fmt.pix.height;
  *fourcc = fmt.fmt.pix.pixelformat;

  auto *h = new V4l2Cap();
  h->fd = fd;
  h->frame_bytes = fmt.fmt.pix.sizeimage;
  h->stride = fmt.fmt.pix.bytesperline;

  v4l2_requestbuffers req;
  memset(&req, 0, sizeof(req));
  req.count = (uint32_t)(n_bufs < 2 ? 2 : (n_bufs > 16 ? 16 : n_bufs));
  req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  req.memory = V4L2_MEMORY_MMAP;
  if (xioctl(fd, VIDIOC_REQBUFS, &req) < 0 || req.count < 2) {
    set_err(err, errlen, "VIDIOC_REQBUFS(MMAP) failed");
    close(fd);
    delete h;
    return nullptr;
  }
  h->n_bufs = req.count;
  for (uint32_t i = 0; i < req.count; i++) {
    v4l2_buffer buf;
    memset(&buf, 0, sizeof(buf));
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    buf.index = i;
    if (xioctl(fd, VIDIOC_QUERYBUF, &buf) < 0) {
      set_err(err, errlen, "VIDIOC_QUERYBUF failed");
      nns_v4l2_close(h);
      return nullptr;
    }
    h->lens[i] = buf.length;
    h->maps[i] = mmap(nullptr, buf.length, PROT_READ | PROT_WRITE,
                      MAP_SHARED, fd, buf.m.offset);
    if (h->maps[i] == MAP_FAILED) {
      h->maps[i] = nullptr;
      set_err(err, errlen, "mmap of capture buffer failed");
      nns_v4l2_close(h);
      return nullptr;
    }
    if (xioctl(fd, VIDIOC_QBUF, &buf) < 0) {
      set_err(err, errlen, "initial VIDIOC_QBUF failed");
      nns_v4l2_close(h);
      return nullptr;
    }
  }
  v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  if (xioctl(fd, VIDIOC_STREAMON, &type) < 0) {
    set_err(err, errlen, "VIDIOC_STREAMON failed");
    nns_v4l2_close(h);
    return nullptr;
  }
  return h;
}

long nns_v4l2_frame_bytes(void *handle) {
  return (long)((V4l2Cap *)handle)->frame_bytes;
}

long nns_v4l2_stride(void *handle) {
  return (long)((V4l2Cap *)handle)->stride;
}

// One frame into `out` (<= cap bytes).  Returns payload bytes, 0 on
// timeout (caller polls its stop event and retries), <0 on device error.
long nns_v4l2_capture(void *handle, uint8_t *out, uint64_t cap,
                      int timeout_ms) {
  V4l2Cap *h = (V4l2Cap *)handle;
  fd_set fds;
  FD_ZERO(&fds);
  FD_SET(h->fd, &fds);
  timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  int r = select(h->fd + 1, &fds, nullptr, nullptr, &tv);
  if (r == 0) return 0;
  if (r < 0) return -1;
  v4l2_buffer buf;
  memset(&buf, 0, sizeof(buf));
  buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
  buf.memory = V4L2_MEMORY_MMAP;
  if (xioctl(h->fd, VIDIOC_DQBUF, &buf) < 0) {
    return errno == EAGAIN ? 0 : -1;
  }
  uint64_t n = buf.bytesused ? buf.bytesused : h->frame_bytes;
  if (n > cap) n = cap;
  memcpy(out, h->maps[buf.index], n);
  if (xioctl(h->fd, VIDIOC_QBUF, &buf) < 0) return -1;
  return (long)n;
}

void nns_v4l2_close(void *handle) {
  V4l2Cap *h = (V4l2Cap *)handle;
  if (h->fd >= 0) {
    v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    xioctl(h->fd, VIDIOC_STREAMOFF, &type);
  }
  for (uint32_t i = 0; i < 16; i++) {
    if (h->maps[i]) munmap(h->maps[i], h->lens[i]);
  }
  if (h->fd >= 0) close(h->fd);
  delete h;
}

}  // extern "C"
