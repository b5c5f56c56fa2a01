// Native (C++) binary serving front for the fused retrieval path.
//
// The Python HTTP front (serving/serve_cli.py /v1/search) spends one core
// per request on HTTP parsing, JSON and base64. This front moves the
// host-bound work off Python: native threads accept connections, parse
// length-prefixed binary frames, and coalesce whatever is queued; Python
// only wakes up once per BATCH (anr_serve_poll fills caller-provided
// buffers), runs the device call, and hands back raw result buffers
// (anr_serve_reply) that native code frames and writes.
//
// Where the reference serves one query at a time through Streamlit
// callbacks (reference src/app.py:200-229 -> query_rag.py:263), batches
// form here at the socket layer, so the GPU sees wide batches and the
// host layer never touches per-row Python objects.
//
// Wire protocol (little-endian; dim / t_max are fixed per server and
// validated against each frame's payload length):
//   request  "ANRQ" u32 | u32 payload_len | u32 req_id, u16 n_rows,
//            u16 flags(bit0 = has terms, bit1 = bf16 embeddings,
//                      bit2 = int8 embeddings)
//            | emb rows (f32; bf16 u16 when the server runs wire_esz=2;
//              int8 + one trailing f32 per-row scale when wire_esz=1 —
//              row stride dim+4. The flag bits must match the server
//              mode.)
//            | i32 terms[n_rows*t_max] (iff flags&1)
//   reply    "ANRP" u32 | u32 payload_len | u32 req_id, u16 n_rows,
//            u16 n_out | i32 rows[n_rows*n_out] | f32 scores[...]
//   error    "ANRE" u32 | u32 payload_len | u32 req_id, utf-8 message
//
// Threading: one accept thread; one blocking reader thread per
// connection (client counts are small — clients batch client-side and
// pipeline); replies are written from the caller's thread under a
// per-connection write mutex. All Python entry points are plain C
// symbols loaded through ctypes (GIL released for the whole poll wait).

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagicReq = 0x51524E41;  // "ANRQ" little-endian
constexpr uint32_t kMagicRep = 0x50524E41;  // "ANRP"
constexpr uint32_t kMagicErr = 0x45524E41;  // "ANRE"

struct Conn {
  int fd = -1;
  std::mutex write_mu;
  std::atomic<bool> open{true};

  ~Conn() {
    if (fd >= 0) ::close(fd);
  }
};

struct Request {
  std::shared_ptr<Conn> conn;
  uint32_t req_id = 0;
  uint16_t n_rows = 0;
  bool has_terms = false;
  std::vector<char> emb;      // [n_rows * dim * wire_esz] raw payload
  std::vector<int32_t> terms; // [n_rows * t_max] when has_terms
};

bool send_all(Conn& c, const void* data, size_t len) {
  const char* p = static_cast<const char*>(data);
  while (len > 0) {
    ssize_t n = ::send(c.fd, p, len, MSG_NOSIGNAL);
    if (n <= 0) {
      c.open.store(false);
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool recv_all(int fd, void* data, size_t len) {
  char* p = static_cast<char*>(data);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n <= 0) return false;
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

struct Server {
  int listen_fd = -1;
  int port = 0;
  int dim = 0;
  int t_max = 0;
  int wire_esz = 4;  // bytes per embedding element on the wire (4|2|1)

  // Bytes of one embedding row on the wire and in poll's emb_out: in
  // int8 mode (wire_esz == 1) each row carries a trailing f32 scale.
  size_t row_bytes() const {
    return static_cast<size_t>(dim) * wire_esz + (wire_esz == 1 ? 4 : 0);
  }
  int max_frame_rows = 0;
  std::atomic<bool> running{true};

  std::mutex queue_mu;
  std::condition_variable queue_cv;
  std::condition_variable space_cv;  // readers wait for queue space
  std::deque<Request> queue;
  size_t queued_rows = 0;     // rows currently waiting (for wait policy)
  size_t max_queued_rows = 0; // backpressure cap (0 = unbounded)

  std::mutex pending_mu;
  uint64_t next_token = 1;
  std::unordered_map<uint64_t, Request> pending;

  std::thread accept_thread;
  std::mutex readers_mu;
  std::vector<std::thread> readers;
  std::vector<std::weak_ptr<Conn>> conns;  // guarded by readers_mu

  std::atomic<uint64_t> frames_in{0};
  std::atomic<uint64_t> rows_in{0};
  std::atomic<uint64_t> bad_frames{0};

  void send_error(Conn& c, uint32_t req_id, const std::string& msg) {
    std::vector<char> buf(12 + msg.size());
    uint32_t len = static_cast<uint32_t>(4 + msg.size());
    std::memcpy(buf.data(), &kMagicErr, 4);
    std::memcpy(buf.data() + 4, &len, 4);
    std::memcpy(buf.data() + 8, &req_id, 4);
    std::memcpy(buf.data() + 12, msg.data(), msg.size());
    std::lock_guard<std::mutex> lk(c.write_mu);
    send_all(c, buf.data(), buf.size());
  }

  void reader_loop(std::shared_ptr<Conn> conn) {
    const size_t emb_bytes = row_bytes();
    const size_t term_bytes = static_cast<size_t>(t_max) * 4;
    std::vector<char> payload;
    while (running.load()) {
      uint32_t head[2];
      if (!recv_all(conn->fd, head, 8)) break;
      if (head[0] != kMagicReq) {
        bad_frames.fetch_add(1);
        break;  // protocol desync: drop the connection
      }
      uint32_t plen = head[1];
      // 8-byte frame header + plausible row payload only. Bound with
      // the f32 element size regardless of server mode, so a
      // wrong-dtype frame still parses far enough to get the clean
      // "wire dtype mismatch" reply below instead of a dropped
      // connection.
      if (plen < 8 || plen > 8 + static_cast<uint64_t>(max_frame_rows) *
                                     (std::max(static_cast<size_t>(dim) * 4,
                                               emb_bytes) +
                                      term_bytes)) {
        bad_frames.fetch_add(1);
        break;
      }
      payload.resize(plen);
      if (!recv_all(conn->fd, payload.data(), plen)) break;
      Request req;
      std::memcpy(&req.req_id, payload.data(), 4);
      uint16_t n_rows, flags;
      std::memcpy(&n_rows, payload.data() + 4, 2);
      std::memcpy(&flags, payload.data() + 6, 2);
      req.n_rows = n_rows;
      req.has_terms = (flags & 1) != 0;
      const int frame_esz = (flags & 2) ? 2 : (flags & 4) ? 1 : 4;
      if (frame_esz != wire_esz) {
        bad_frames.fetch_add(1);
        const char* want = wire_esz == 2   ? "bf16"
                           : wire_esz == 1 ? "int8"
                                           : "f32";
        send_error(*conn, req.req_id,
                   std::string("wire dtype mismatch: server expects ") +
                       want);
        continue;
      }
      size_t want = 8 + n_rows * emb_bytes +
                    (req.has_terms ? n_rows * term_bytes : 0);
      if (n_rows == 0 || n_rows > max_frame_rows || want != plen) {
        bad_frames.fetch_add(1);
        send_error(*conn, req.req_id, "bad frame: row/size mismatch");
        continue;
      }
      req.conn = conn;
      req.emb.resize(static_cast<size_t>(n_rows) * emb_bytes);
      std::memcpy(req.emb.data(), payload.data() + 8, n_rows * emb_bytes);
      if (req.has_terms) {
        req.terms.resize(static_cast<size_t>(n_rows) * t_max);
        std::memcpy(req.terms.data(), payload.data() + 8 + n_rows * emb_bytes,
                    n_rows * term_bytes);
      }
      frames_in.fetch_add(1);
      rows_in.fetch_add(n_rows);
      {
        // Backpressure: a client pipelining faster than the device
        // drains must not grow the queue without bound — block the
        // reader (the client's TCP window fills in turn) until poll
        // frees space or the server stops.
        std::unique_lock<std::mutex> lk(queue_mu);
        if (max_queued_rows > 0) {
          space_cv.wait(lk, [this] {
            return queued_rows < max_queued_rows || !running.load();
          });
          if (!running.load()) break;
        }
        queued_rows += n_rows;
        queue.push_back(std::move(req));
      }
      queue_cv.notify_one();
    }
    conn->open.store(false);
  }

  void accept_loop() {
    while (running.load()) {
      int fd = ::accept(listen_fd, nullptr, nullptr);
      if (fd < 0) {
        if (!running.load()) break;
        continue;
      }
      int one = 1;
      ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      auto conn = std::make_shared<Conn>();
      conn->fd = fd;
      std::lock_guard<std::mutex> lk(readers_mu);
      conns.push_back(conn);
      readers.emplace_back([this, conn] { reader_loop(conn); });
    }
  }
};

}  // namespace

extern "C" {

// Start a server on host:port (port 0 picks a free port). host may be
// a numeric IPv4 literal or a resolvable hostname (getaddrinfo, IPv4).
// max_queued_rows > 0 bounds the request queue: readers block (TCP
// backpressure) once that many rows wait. wire_esz is the embedding
// element width on the wire: 4 (f32), 2 (bf16 — halves both the
// client socket bytes and, because the Python dispatcher uploads the
// rows as-is, the host->device transfer), or 1 (int8 rows with a
// trailing f32 per-row scale, stride dim+4 — quarters the socket
// bytes; the dispatcher uploads int8+scales and dequantizes on
// device). Returns an opaque handle, or nullptr on resolve/bind
// failure or a bad wire_esz.
void* anr_serve_start(const char* host, int port, int dim, int t_max,
                      int max_frame_rows, int max_queued_rows,
                      int wire_esz) {
  if (wire_esz != 1 && wire_esz != 2 && wire_esz != 4) return nullptr;
  auto* s = new Server();
  s->dim = dim;
  s->t_max = t_max;
  s->wire_esz = wire_esz;
  s->max_frame_rows = max_frame_rows > 0 ? max_frame_rows : 4096;
  s->max_queued_rows =
      max_queued_rows > 0 ? static_cast<size_t>(max_queued_rows) : 0;
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  const char* h = host && *host ? host : "127.0.0.1";
  if (::inet_pton(AF_INET, h, &addr.sin_addr) != 1) {
    // Not a numeric literal: resolve (e.g. "localhost").
    addrinfo hints{};
    hints.ai_family = AF_INET;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (::getaddrinfo(h, nullptr, &hints, &res) != 0 || res == nullptr) {
      ::close(s->listen_fd);
      delete s;
      return nullptr;
    }
    addr.sin_addr = reinterpret_cast<sockaddr_in*>(res->ai_addr)->sin_addr;
    ::freeaddrinfo(res);
  }
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr*>(&addr),
             sizeof(addr)) != 0 ||
      ::listen(s->listen_fd, 128) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  s->accept_thread = std::thread([s] { s->accept_loop(); });
  return s;
}

int anr_serve_port(void* handle) {
  return handle ? static_cast<Server*>(handle)->port : -1;
}

// Collect up to max_rows rows of queued frames (whole frames only).
// Waits up to wait_ms for the FIRST frame; once one is present, keeps
// collecting stragglers for up to collect_wait_ms (0 = ship whatever
// is queued immediately) or until max_rows are waiting — this is the
// native analog of the Python scheduler's batch-formation window.
// Fills:
//   emb_out    [max_rows * row_bytes] raw rows (f32 / bf16 per the
//              server's wire_esz; int8 rows carry a trailing f32
//              scale, stride dim+4), frames back to back
//   terms_out  [max_rows * t_max] i32, -1-padded for frames w/o terms
//   tokens_out [max_frames] u64 reply tokens
//   rows_out   [max_frames] i32 per-frame row counts
// Returns the number of frames batched (0 on timeout, -1 if stopped).
int anr_serve_poll(void* handle, int max_rows, double wait_ms,
                   void* emb_out, int32_t* terms_out, uint64_t* tokens_out,
                   int32_t* rows_out, int max_frames, double collect_wait_ms) {
  if (!handle) return -1;
  auto* s = static_cast<Server*>(handle);
  std::unique_lock<std::mutex> lk(s->queue_mu);
  if (s->queue.empty()) {
    s->queue_cv.wait_for(
        lk, std::chrono::microseconds(static_cast<int64_t>(wait_ms * 1e3)),
        [s] { return !s->queue.empty() || !s->running.load(); });
  }
  if (!s->running.load()) return -1;
  if (!s->queue.empty() && collect_wait_ms > 0 &&
      s->queued_rows < static_cast<size_t>(max_rows)) {
    auto deadline = std::chrono::steady_clock::now() +
                    std::chrono::microseconds(
                        static_cast<int64_t>(collect_wait_ms * 1e3));
    while (s->running.load() &&
           s->queued_rows < static_cast<size_t>(max_rows)) {
      if (s->queue_cv.wait_until(lk, deadline) ==
          std::cv_status::timeout)
        break;
    }
    if (!s->running.load()) return -1;
  }
  int n_frames = 0;
  int rows = 0;
  std::vector<Request> batch;
  while (!s->queue.empty() && n_frames < max_frames) {
    Request& front = s->queue.front();
    if (rows + front.n_rows > max_rows) break;
    rows += front.n_rows;
    s->queued_rows -= front.n_rows;
    batch.push_back(std::move(front));
    s->queue.pop_front();
    ++n_frames;
  }
  lk.unlock();
  if (n_frames > 0) s->space_cv.notify_all();  // wake blocked readers
  if (n_frames == 0) return 0;
  int row_off = 0;
  std::lock_guard<std::mutex> plk(s->pending_mu);
  const size_t row_bytes = s->row_bytes();
  for (int i = 0; i < n_frames; ++i) {
    Request& r = batch[i];
    std::memcpy(static_cast<char*>(emb_out) +
                    static_cast<size_t>(row_off) * row_bytes,
                r.emb.data(), r.emb.size());
    int32_t* t = terms_out + static_cast<size_t>(row_off) * s->t_max;
    if (r.has_terms) {
      std::memcpy(t, r.terms.data(), r.terms.size() * 4);
    } else {
      std::fill(t, t + static_cast<size_t>(r.n_rows) * s->t_max, -1);
    }
    rows_out[i] = r.n_rows;
    uint64_t tok = s->next_token++;
    tokens_out[i] = tok;
    row_off += r.n_rows;
    r.emb.clear();
    r.emb.shrink_to_fit();
    r.terms.clear();
    r.terms.shrink_to_fit();
    s->pending.emplace(tok, std::move(r));
  }
  return n_frames;
}

// Rows waiting in the queue right now (for adaptive batching policies).
int anr_serve_queued_rows(void* handle) {
  if (!handle) return -1;
  auto* s = static_cast<Server*>(handle);
  std::lock_guard<std::mutex> lk(s->queue_mu);
  return static_cast<int>(s->queued_rows);
}

// Send a reply for a token returned by poll. rows/scores are
// [n_rows * n_out]. Returns 0 on success, -1 unknown token, -2 if the
// client connection is gone (reply dropped).
int anr_serve_reply(void* handle, uint64_t token, int n_rows, int n_out,
                    const int32_t* rows, const float* scores) {
  if (!handle) return -1;
  auto* s = static_cast<Server*>(handle);
  Request req;
  {
    std::lock_guard<std::mutex> lk(s->pending_mu);
    auto it = s->pending.find(token);
    if (it == s->pending.end()) return -1;
    req = std::move(it->second);
    s->pending.erase(it);
  }
  if (!req.conn || !req.conn->open.load()) return -2;
  size_t body = static_cast<size_t>(n_rows) * n_out * 8;
  std::vector<char> buf(16 + body);
  uint32_t plen = static_cast<uint32_t>(8 + body);
  uint16_t nr = static_cast<uint16_t>(n_rows);
  uint16_t no = static_cast<uint16_t>(n_out);
  std::memcpy(buf.data(), &kMagicRep, 4);
  std::memcpy(buf.data() + 4, &plen, 4);
  std::memcpy(buf.data() + 8, &req.req_id, 4);
  std::memcpy(buf.data() + 12, &nr, 2);
  std::memcpy(buf.data() + 14, &no, 2);
  std::memcpy(buf.data() + 16, rows, static_cast<size_t>(n_rows) * n_out * 4);
  std::memcpy(buf.data() + 16 + static_cast<size_t>(n_rows) * n_out * 4,
              scores, static_cast<size_t>(n_rows) * n_out * 4);
  std::lock_guard<std::mutex> lk(req.conn->write_mu);
  return send_all(*req.conn, buf.data(), buf.size()) ? 0 : -2;
}

// Send an error frame for a token (e.g. device dispatch failed).
int anr_serve_reply_error(void* handle, uint64_t token, const char* msg) {
  if (!handle) return -1;
  auto* s = static_cast<Server*>(handle);
  Request req;
  {
    std::lock_guard<std::mutex> lk(s->pending_mu);
    auto it = s->pending.find(token);
    if (it == s->pending.end()) return -1;
    req = std::move(it->second);
    s->pending.erase(it);
  }
  if (!req.conn || !req.conn->open.load()) return -2;
  s->send_error(*req.conn, req.req_id, msg ? msg : "server error");
  return 0;
}

void anr_serve_stats(void* handle, uint64_t* frames, uint64_t* rows,
                     uint64_t* bad) {
  if (!handle) return;
  auto* s = static_cast<Server*>(handle);
  if (frames) *frames = s->frames_in.load();
  if (rows) *rows = s->rows_in.load();
  if (bad) *bad = s->bad_frames.load();
}

// Phase 1: stop accepting/reading and wake every blocked poll. The
// handle stays valid — callers may still be inside poll/reply on other
// threads; they see running=false / missing tokens and drain out.
// Call anr_serve_free only after all caller threads have joined.
void anr_serve_stop(void* handle) {
  if (!handle) return;
  auto* s = static_cast<Server*>(handle);
  s->running.store(false);
  s->space_cv.notify_all();
  // Unblock accept() and every reader by shutting the sockets down.
  ::shutdown(s->listen_fd, SHUT_RDWR);
  ::close(s->listen_fd);
  s->queue_cv.notify_all();
  if (s->accept_thread.joinable()) s->accept_thread.join();
  // Readers block in recv(); shutdown every live connection to force
  // them out, then join.
  std::vector<std::thread> readers;
  {
    std::lock_guard<std::mutex> lk(s->readers_mu);
    for (auto& w : s->conns)
      if (auto c = w.lock()) {
        c->open.store(false);
        ::shutdown(c->fd, SHUT_RDWR);
      }
    readers.swap(s->readers);
  }
  for (auto& t : readers)
    if (t.joinable()) t.join();
  {
    std::lock_guard<std::mutex> plk(s->pending_mu);
    s->pending.clear();
  }
  {
    std::lock_guard<std::mutex> lk(s->queue_mu);
    s->queue.clear();
    s->queued_rows = 0;
  }
}

// Phase 2: release the server. No other thread may hold the handle.
void anr_serve_free(void* handle) {
  delete static_cast<Server*>(handle);
}

}  // extern "C"
