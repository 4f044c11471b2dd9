// vtl — vproxy-tpu host runtime: epoll event loop, nonblocking socket
// syscall layer, and a native bidirectional splice pump.
//
// Role: the C++ equivalent of the reference's native layer (redis-ae event
// loop dep/ae/ae.c + JNI socket layer vfd_posix_GeneralPosix.c — see
// SURVEY.md §2.7), redesigned for a Python-orchestrated data plane: Python
// owns accept/classify/connect decisions; byte shoveling for spliced TCP
// sessions runs entirely in C (vtl_pump), so the per-byte path never
// crosses into the interpreter.
//
// C ABI only (ctypes-friendly). Level-triggered epoll with explicit
// interest management.
#include <arpa/inet.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <poll.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <sys/un.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <algorithm>
#include <vector>

#define VTL_EV_READ 1u
#define VTL_EV_WRITE 2u
#define VTL_EV_ERROR 4u
// pump lifecycle notifications delivered through vtl_poll
#define VTL_EV_PUMP_DONE 8u

extern "C" {

// ---------------------------------------------------------------- sockets


static int mk_addr(const char* ip, int port, int v6, sockaddr_storage* ss,
                   socklen_t* len) {
  memset(ss, 0, sizeof(*ss));
  if (v6) {
    auto* a = (sockaddr_in6*)ss;
    a->sin6_family = AF_INET6;
    a->sin6_port = htons((uint16_t)port);
    if (inet_pton(AF_INET6, ip, &a->sin6_addr) != 1) return -EINVAL;
    *len = sizeof(sockaddr_in6);
  } else {
    auto* a = (sockaddr_in*)ss;
    a->sin_family = AF_INET;
    a->sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, ip, &a->sin_addr) != 1) return -EINVAL;
    *len = sizeof(sockaddr_in);
  }
  return 0;
}

int vtl_tcp_listen(const char* ip, int port, int backlog, int reuseport,
                   int v6) {
  int fd = socket(v6 ? AF_INET6 : AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (reuseport) setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  sockaddr_storage ss;
  socklen_t len;
  int r = mk_addr(ip, port, v6, &ss, &len);
  if (r < 0) { close(fd); return r; }
  if (bind(fd, (sockaddr*)&ss, len) < 0) { r = -errno; close(fd); return r; }
  if (listen(fd, backlog) < 0) { r = -errno; close(fd); return r; }
  return fd;
}

// returns client fd; fills ip string (INET6_ADDRSTRLEN) and port
int vtl_accept(int lfd, char* ipbuf, int ipbuflen, int* port) {
  sockaddr_storage ss;
  socklen_t len = sizeof(ss);
  int fd = accept4(lfd, (sockaddr*)&ss, &len, SOCK_NONBLOCK | SOCK_CLOEXEC);
  if (fd < 0) return -errno;
  if (ss.ss_family == AF_INET) {
    auto* a = (sockaddr_in*)&ss;
    inet_ntop(AF_INET, &a->sin_addr, ipbuf, ipbuflen);
    *port = ntohs(a->sin_port);
  } else if (ss.ss_family == AF_INET6) {
    auto* a = (sockaddr_in6*)&ss;
    inet_ntop(AF_INET6, &a->sin6_addr, ipbuf, ipbuflen);
    *port = ntohs(a->sin6_port);
  } else {  // AF_UNIX peer: no address to report
    if (ipbuflen > 0) ipbuf[0] = 0;
    *port = 0;
  }
  return fd;
}

// unix-domain stream listener (UDSPath analog). Removes a stale socket
// file first if nothing is accepting on it.
int vtl_unix_listen(const char* path, int backlog) {
  sockaddr_un sa;
  if (strlen(path) >= sizeof(sa.sun_path)) return -ENAMETOOLONG;
  struct stat st;
  if (stat(path, &st) == 0) {
    if (!S_ISSOCK(st.st_mode)) return -EADDRINUSE;  // never unlink non-sockets
    int probe = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
    if (probe >= 0) {
      memset(&sa, 0, sizeof(sa));
      sa.sun_family = AF_UNIX;
      strcpy(sa.sun_path, path);
      if (connect(probe, (sockaddr*)&sa, sizeof(sa)) < 0 &&
          (errno == ECONNREFUSED || errno == ENOENT)) {
        unlink(path);  // dead leftover from a previous process
      }
      close(probe);
    }
  }
  int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  memset(&sa, 0, sizeof(sa));
  sa.sun_family = AF_UNIX;
  strcpy(sa.sun_path, path);
  int r;
  if (bind(fd, (sockaddr*)&sa, sizeof(sa)) < 0) { r = -errno; close(fd); return r; }
  if (listen(fd, backlog) < 0) { r = -errno; close(fd); return r; }
  return fd;
}

int vtl_unix_connect(const char* path) {
  sockaddr_un sa;
  if (strlen(path) >= sizeof(sa.sun_path)) return -ENAMETOOLONG;
  int fd = socket(AF_UNIX, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  memset(&sa, 0, sizeof(sa));
  sa.sun_family = AF_UNIX;
  strcpy(sa.sun_path, path);
  if (connect(fd, (sockaddr*)&sa, sizeof(sa)) < 0 && errno != EINPROGRESS) {
    int r = -errno;
    close(fd);
    return r;
  }
  return fd;
}

int vtl_tcp_connect(const char* ip, int port, int v6) {
  int fd = socket(v6 ? AF_INET6 : AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  sockaddr_storage ss;
  socklen_t len;
  int r = mk_addr(ip, port, v6, &ss, &len);
  if (r < 0) { close(fd); return r; }
  if (connect(fd, (sockaddr*)&ss, len) < 0 && errno != EINPROGRESS) {
    r = -errno;
    close(fd);
    return r;
  }
  return fd;
}

int vtl_finish_connect(int fd) {
  int err = 0;
  socklen_t len = sizeof(err);
  if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) < 0) return -errno;
  return -err;  // 0 ok, else -errno of the failed connect
}

int vtl_udp_bind(const char* ip, int port, int v6, int reuseport) {
  int fd = socket(v6 ? AF_INET6 : AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
  if (fd < 0) return -errno;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  if (reuseport) setsockopt(fd, SOL_SOCKET, SO_REUSEPORT, &one, sizeof(one));
  sockaddr_storage ss;
  socklen_t len;
  int r = mk_addr(ip, port, v6, &ss, &len);
  if (r < 0) { close(fd); return r; }
  if (bind(fd, (sockaddr*)&ss, len) < 0) { r = -errno; close(fd); return r; }
  return fd;
}

int vtl_udp_socket(int v6) {
  int fd = socket(v6 ? AF_INET6 : AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
  return fd < 0 ? -errno : fd;
}

int vtl_recvfrom(int fd, void* buf, int len, char* ipbuf, int ipbuflen,
                 int* port) {
  sockaddr_storage ss;
  socklen_t slen = sizeof(ss);
  ssize_t n = recvfrom(fd, buf, (size_t)len, 0, (sockaddr*)&ss, &slen);
  if (n < 0) return -errno;
  if (ss.ss_family == AF_INET) {
    auto* a = (sockaddr_in*)&ss;
    inet_ntop(AF_INET, &a->sin_addr, ipbuf, ipbuflen);
    *port = ntohs(a->sin_port);
  } else if (ss.ss_family == AF_INET6) {
    auto* a = (sockaddr_in6*)&ss;
    inet_ntop(AF_INET6, &a->sin6_addr, ipbuf, ipbuflen);
    *port = ntohs(a->sin6_port);
  }
  return (int)n;
}

int vtl_sendto(int fd, const void* buf, int len, const char* ip, int port,
               int v6) {
  sockaddr_storage ss;
  socklen_t slen;
  int r = mk_addr(ip, port, v6, &ss, &slen);
  if (r < 0) return r;
  ssize_t n = sendto(fd, buf, (size_t)len, 0, (sockaddr*)&ss, slen);
  return n < 0 ? -errno : (int)n;
}

// Batched datagram ingress: one syscall (and one ctypes crossing)
// drains up to `maxmsgs` datagrams into `buf` sliced as fixed `slot`-
// byte cells. lens[i] = datagram size (truncated to slot), ips is a
// maxmsgs x ipstride char matrix, ports[i] the sender port. Returns
// message count, 0 on EAGAIN, -errno on error.
int vtl_recvmmsg(int fd, void* buf, int slot, int maxmsgs, int* lens,
                 char* ips, int ipstride, int* ports) {
  if (maxmsgs > 512) maxmsgs = 512;
  static thread_local mmsghdr hdrs[512];
  static thread_local iovec iovs[512];
  static thread_local sockaddr_storage addrs[512];
  for (int i = 0; i < maxmsgs; ++i) {
    iovs[i].iov_base = (char*)buf + (size_t)i * slot;
    iovs[i].iov_len = (size_t)slot;
    memset(&hdrs[i].msg_hdr, 0, sizeof(msghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
    hdrs[i].msg_hdr.msg_name = &addrs[i];
    hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_storage);
  }
  int n = recvmmsg(fd, hdrs, (unsigned)maxmsgs, MSG_DONTWAIT, nullptr);
  if (n < 0) return (errno == EAGAIN || errno == EWOULDBLOCK) ? 0 : -errno;
  for (int i = 0; i < n; ++i) {
    lens[i] = (int)hdrs[i].msg_len;
    char* ip = ips + (size_t)i * ipstride;
    ip[0] = 0;
    ports[i] = 0;
    if (addrs[i].ss_family == AF_INET) {
      auto* a = (sockaddr_in*)&addrs[i];
      inet_ntop(AF_INET, &a->sin_addr, ip, ipstride);
      ports[i] = ntohs(a->sin_port);
    } else if (addrs[i].ss_family == AF_INET6) {
      auto* a = (sockaddr_in6*)&addrs[i];
      inet_ntop(AF_INET6, &a->sin6_addr, ip, ipstride);
      ports[i] = ntohs(a->sin6_port);
    }
  }
  return n;
}

// Batched same-destination egress (the fast path's per-iface groups):
// one sendmmsg for n datagrams given as (ptrs[i], lens[i]). Returns
// the number actually sent (datagram sockets: the rest were dropped
// by buffer pressure — acceptable for a switch) or -errno.
int vtl_sendmmsg(int fd, const void* const* ptrs, const int* lens, int n,
                 const char* ip, int port, int v6) {
  if (n > 512) n = 512;
  sockaddr_storage ss;
  socklen_t slen;
  int r = mk_addr(ip, port, v6, &ss, &slen);
  if (r < 0) return r;
  static thread_local mmsghdr hdrs[512];
  static thread_local iovec iovs[512];
  for (int i = 0; i < n; ++i) {
    iovs[i].iov_base = (void*)ptrs[i];
    iovs[i].iov_len = (size_t)lens[i];
    memset(&hdrs[i].msg_hdr, 0, sizeof(msghdr));
    hdrs[i].msg_hdr.msg_iov = &iovs[i];
    hdrs[i].msg_hdr.msg_iovlen = 1;
    hdrs[i].msg_hdr.msg_name = &ss;
    hdrs[i].msg_hdr.msg_namelen = slen;
  }
  int sent = sendmmsg(fd, hdrs, (unsigned)n, 0);
  if (sent < 0)
    return (errno == EAGAIN || errno == EWOULDBLOCK) ? 0 : -errno;
  return sent;
}

int vtl_read(int fd, void* buf, int len) {
  ssize_t n = read(fd, buf, (size_t)len);
  return n < 0 ? -errno : (int)n;
}

int vtl_write(int fd, const void* buf, int len) {
  ssize_t n = write(fd, buf, (size_t)len);
  return n < 0 ? -errno : (int)n;
}

int vtl_close(int fd) { return close(fd) < 0 ? -errno : 0; }

// RST close (SO_LINGER{1,0}): the overload-shed path — one call, no
// python socket-object round trip per refused connection
int vtl_close_rst(int fd) {
  struct linger lg = {1, 0};
  setsockopt(fd, SOL_SOCKET, SO_LINGER, &lg, sizeof(lg));
  return close(fd) < 0 ? -errno : 0;
}

int vtl_shutdown_wr(int fd) { return shutdown(fd, SHUT_WR) < 0 ? -errno : 0; }

int vtl_set_rcvbuf(int fd, int bytes) {
  return setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &bytes, sizeof(bytes)) < 0
             ? -errno : 0;
}

int vtl_set_nodelay(int fd, int on) {
  return setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &on, sizeof(on)) < 0
             ? -errno : 0;
}

// TCP_DEFER_ACCEPT on a listener: the kernel completes the handshake but
// only surfaces the connection to accept() once data arrives (or the
// timeout expires) — empty accepts never wake the accept loop. For
// client-speaks-first workloads only; a server-first protocol behind a
// deferred listener waits out `seconds` before its first byte.
int vtl_set_defer_accept(int fd, int seconds) {
  return setsockopt(fd, IPPROTO_TCP, TCP_DEFER_ACCEPT, &seconds,
                    sizeof(seconds)) < 0 ? -errno : 0;
}

int vtl_sock_name(int fd, int peer, char* ipbuf, int ipbuflen, int* port) {
  sockaddr_storage ss;
  socklen_t len = sizeof(ss);
  int r = peer ? getpeername(fd, (sockaddr*)&ss, &len)
               : getsockname(fd, (sockaddr*)&ss, &len);
  if (r < 0) return -errno;
  if (ss.ss_family == AF_INET) {
    auto* a = (sockaddr_in*)&ss;
    inet_ntop(AF_INET, &a->sin_addr, ipbuf, ipbuflen);
    *port = ntohs(a->sin_port);
  } else if (ss.ss_family == AF_INET6) {
    auto* a = (sockaddr_in6*)&ss;
    inet_ntop(AF_INET6, &a->sin6_addr, ipbuf, ipbuflen);
    *port = ntohs(a->sin6_port);
  } else {  // AF_UNIX: report the bound path (empty for the peer side)
    auto* a = (sockaddr_un*)&ss;
    strncpy(ipbuf, len > sizeof(sa_family_t) ? a->sun_path : "", ipbuflen - 1);
    ipbuf[ipbuflen - 1] = 0;
    *port = 0;
  }
  return 0;
}

// ---------------------------------------------------------------- loop

struct Pump;
struct Lane;

struct Handler {
  enum Kind { PY = 0, WAKE = 1, PUMP_A = 2, PUMP_B = 3, LANE = 4 } kind;
  uint64_t tag;   // PY: python tag; PUMP_*: owning pump id
  Pump* pump;     // PUMP_* only
  int fd;
  uint32_t interest;  // current epoll interest (VTL_EV_*)
  // --- io_uring engine bookkeeping (accept lanes; zero-cost on epoll)
  // One oneshot POLL_ADD at a time per fd; pending_ev remembers what it
  // was armed for so an interest change mid-flight cancels + re-arms.
  // inflight counts CQEs still owed to this handler — its memory must
  // not be freed until they have all drained (uring user_data holds the
  // raw pointer; see lane garbage collection).
  uint16_t pending_ev = 0;
  bool poll_pending = false;
  bool ms_accept = false;   // LANE: multishot accept currently armed
  int inflight = 0;
};

struct Ring {
  std::vector<char> buf;
  size_t head = 0, size = 0;  // ring of buf.size()
  explicit Ring(size_t cap) : buf(cap) {}
  size_t cap() const { return buf.size(); }
  size_t free_() const { return cap() - size; }
  bool empty() const { return size == 0; }
  bool full() const { return size == cap(); }
};

struct Pump {
  uint64_t id;
  int fd_a, fd_b;
  Ring a2b, b2a;
  bool a_eof = false, b_eof = false;       // read side closed
  bool a_wr_shut = false, b_wr_shut = false;
  bool dead = false;
  // accept fast lane (vtl_pump_connect): B is still mid-connect; the
  // pump idles until the handshake resolves. A failed connect reports
  // connect_failed and leaves fd_a OPEN for the python retry layer.
  // created_us/connect_us let python report the TRUE backend-connect
  // span (the classic path measures it in on_connected; the fast lane
  // only hears back at DONE, so the duration rides the stat).
  bool b_connecting = false;
  bool connect_failed = false;
  uint64_t created_us = 0;
  uint64_t connect_us = (uint64_t)-1;  // -1 = not resolved yet
  int err = 0;
  uint64_t bytes_a2b = 0, bytes_b2a = 0;
  // TLS-terminating pumps (vtl_tls_pump_new): side A is a TLS client
  // (this process is the server), side B plaintext; ssl owns the
  // record layer over fd_a via SSL_set_fd.
  void* ssl = nullptr;
  bool handshaking = false;
  // A-side SSL demands, split by direction: SSL_read's WANT_READ is the
  // NORMAL idle state (no complete record) and must not stall B->A;
  // only SSL_write's wants gate the write flush.
  bool rd_want_write = false;               // SSL_read needs fd writable
  bool wr_want_read = false, wr_want_write = false;  // SSL_write stalled
  bool hs_want_write = false;
  Pump(uint64_t i, int a, int b, size_t cap)
      : id(i), fd_a(a), fd_b(b), a2b(cap), b2a(cap) {}
};

struct Uring;

struct Loop {
  int ep = -1;
  int wakefd = -1;
  std::unordered_map<int, Handler*> handlers;  // by fd
  std::unordered_map<uint64_t, Pump*> pumps;   // by pump id
  std::vector<uint64_t> done_pumps;            // report via poll
  uint64_t next_pump_id = 1;
  // Handlers can be torn down (pump_kill) while later events in the same
  // epoll batch still hold their pointers; removals defer the delete and
  // the poll loop checks membership here before dereferencing.
  std::unordered_set<Handler*> valid;
  std::vector<Handler*> garbage;
  // accept lanes may run this loop on the io_uring engine instead of
  // epoll: readiness is then delivered as batched oneshot-POLL CQEs
  // through one ring (ur != nullptr) and ep stays unused.
  Uring* ur = nullptr;
};

static void drop_handler(Loop* l, Handler* h) {
  l->valid.erase(h);
  l->garbage.push_back(h);
}

static uint32_t to_ep(uint32_t ev) {
  uint32_t e = 0;
  if (ev & VTL_EV_READ) e |= EPOLLIN;
  if (ev & VTL_EV_WRITE) e |= EPOLLOUT;
  return e;
}

static int uring_set_interest(Loop* l, Handler* h, uint32_t interest);
static void uring_detach(Loop* l, Handler* h);
static void uring_free(Uring* u);

static int ep_set(Loop* l, Handler* h, uint32_t interest) {
  if (l->ur) return uring_set_interest(l, h, interest);
  epoll_event e;
  memset(&e, 0, sizeof(e));
  e.events = to_ep(interest);
  e.data.ptr = h;
  int op = h->interest == (uint32_t)-1 ? EPOLL_CTL_ADD : EPOLL_CTL_MOD;
  if (epoll_ctl(l->ep, op, h->fd, &e) < 0) return -errno;
  h->interest = interest;
  return 0;
}

// unregister an fd's readiness source before it closes: epoll_ctl DEL,
// or (uring) cancel the outstanding poll so the ring drops its file
// reference — an fd closed with a live uring poll would never be
// released by the kernel.
static void loop_detach(Loop* l, Handler* h) {
  if (l->ur) {
    uring_detach(l, h);
    return;
  }
  epoll_ctl(l->ep, EPOLL_CTL_DEL, h->fd, nullptr);
}

// NOTE: an earlier round skipped the epoll_ctl DEL for fds that close
// immediately after (Linux auto-removes a closed fd's registration) —
// REVERTED: under full-suite fd-reuse load the kernel
// surfaced stale registrations as EPOLLERR/EIO on live pumps. The DEL
// stays explicit on both engines.

void* vtl_new() {
  Loop* l = new Loop();
  l->ep = epoll_create1(EPOLL_CLOEXEC);
  l->wakefd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  Handler* h = new Handler{Handler::WAKE, 0, nullptr, l->wakefd, (uint32_t)-1};
  l->handlers[l->wakefd] = h;
  l->valid.insert(h);
  ep_set(l, h, VTL_EV_READ);
  return l;
}

int vtl_wakeup(void* lp) {
  Loop* l = (Loop*)lp;
  uint64_t one = 1;
  ssize_t n = write(l->wakefd, &one, 8);
  return n == 8 ? 0 : -errno;
}

int vtl_add(void* lp, int fd, uint32_t events, uint64_t tag) {
  Loop* l = (Loop*)lp;
  if (l->handlers.count(fd)) return -EEXIST;
  Handler* h = new Handler{Handler::PY, tag, nullptr, fd, (uint32_t)-1};
  int r = ep_set(l, h, events);
  if (r < 0) { delete h; return r; }
  l->handlers[fd] = h;
  l->valid.insert(h);
  return 0;
}

int vtl_mod(void* lp, int fd, uint32_t events, uint64_t tag) {
  Loop* l = (Loop*)lp;
  auto it = l->handlers.find(fd);
  if (it == l->handlers.end()) return -ENOENT;
  it->second->tag = tag;
  return ep_set(l, it->second, events);
}

int vtl_del(void* lp, int fd) {
  Loop* l = (Loop*)lp;
  auto it = l->handlers.find(fd);
  if (it == l->handlers.end()) return -ENOENT;
  epoll_ctl(l->ep, EPOLL_CTL_DEL, fd, nullptr);
  drop_handler(l, it->second);
  l->handlers.erase(it);
  return 0;
}

// ---------------------------------------------------------------- openssl
//
// The image ships libssl.so.3 but no development headers, so the needed
// OpenSSL 3 ABI (stable) is declared here and resolved with dlopen at
// vtl_tls_init() time. TLS stays strictly optional: without the library
// every vtl_tls_* call reports -ENOSYS and the plain pump is unaffected.

typedef struct ssl_ctx_st SSL_CTX_;
typedef struct ssl_st SSL_;

#define SSL_FILETYPE_PEM_ 1
#define SSL_CTRL_MODE_ 33
#define SSL_MODE_ENABLE_PARTIAL_WRITE_ 1L
#define SSL_MODE_ACCEPT_MOVING_WRITE_BUFFER_ 2L
#define SSL_ERROR_WANT_READ_ 2
#define SSL_ERROR_WANT_WRITE_ 3
#define SSL_ERROR_SYSCALL_ 5
#define SSL_ERROR_ZERO_RETURN_ 6

static struct {
  bool ready = false;
  const void* (*TLS_server_method)(void);
  SSL_CTX_* (*SSL_CTX_new)(const void*);
  void (*SSL_CTX_free)(SSL_CTX_*);
  int (*SSL_CTX_use_certificate_chain_file)(SSL_CTX_*, const char*);
  int (*SSL_CTX_use_PrivateKey_file)(SSL_CTX_*, const char*, int);
  int (*SSL_CTX_check_private_key)(const SSL_CTX_*);
  long (*SSL_CTX_ctrl)(SSL_CTX_*, int, long, void*);
  SSL_* (*SSL_new)(SSL_CTX_*);
  void (*SSL_free)(SSL_*);
  int (*SSL_set_fd)(SSL_*, int);
  void (*SSL_set_accept_state)(SSL_*);
  int (*SSL_do_handshake)(SSL_*);
  int (*SSL_read)(SSL_*, void*, int);
  int (*SSL_write)(SSL_*, const void*, int);
  int (*SSL_get_error)(const SSL_*, int);
  int (*SSL_shutdown)(SSL_*);
  void (*ERR_clear_error)(void);
} TLSA;

int vtl_tls_init(void) {
  if (TLSA.ready) return 0;
  void* h = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
  if (!h) h = dlopen("libssl.so", RTLD_NOW | RTLD_GLOBAL);
  if (!h) return -ENOSYS;
  void* hc = dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
  if (!hc) hc = dlopen("libcrypto.so", RTLD_NOW | RTLD_GLOBAL);
#define VTL_SYM(lib, name)                                        \
  *(void**)(&TLSA.name) = dlsym(lib, #name);                      \
  if (!TLSA.name) return -ENOSYS;
  VTL_SYM(h, TLS_server_method)
  VTL_SYM(h, SSL_CTX_new)
  VTL_SYM(h, SSL_CTX_free)
  VTL_SYM(h, SSL_CTX_use_certificate_chain_file)
  VTL_SYM(h, SSL_CTX_use_PrivateKey_file)
  VTL_SYM(h, SSL_CTX_check_private_key)
  VTL_SYM(h, SSL_CTX_ctrl)
  VTL_SYM(h, SSL_new)
  VTL_SYM(h, SSL_free)
  VTL_SYM(h, SSL_set_fd)
  VTL_SYM(h, SSL_set_accept_state)
  VTL_SYM(h, SSL_do_handshake)
  VTL_SYM(h, SSL_read)
  VTL_SYM(h, SSL_write)
  VTL_SYM(h, SSL_get_error)
  VTL_SYM(h, SSL_shutdown)
  if (hc) {
    *(void**)(&TLSA.ERR_clear_error) = dlsym(hc, "ERR_clear_error");
  }
  if (!TLSA.ERR_clear_error)
    *(void**)(&TLSA.ERR_clear_error) = dlsym(h, "ERR_clear_error");
  if (!TLSA.ERR_clear_error) return -ENOSYS;
#undef VTL_SYM
  TLSA.ready = true;
  return 0;
}

// -> SSL_CTX handle (as int64) or -errno. One ctx per cert-key; SSL
// objects refcount it, so freeing the ctx after a holder swap is safe
// while sessions created from it live on.
long long vtl_tls_ctx_new(const char* cert_path, const char* key_path) {
  if (!TLSA.ready && vtl_tls_init() < 0) return -ENOSYS;
  SSL_CTX_* ctx = TLSA.SSL_CTX_new(TLSA.TLS_server_method());
  if (!ctx) return -ENOMEM;
  if (TLSA.SSL_CTX_use_certificate_chain_file(ctx, cert_path) != 1 ||
      TLSA.SSL_CTX_use_PrivateKey_file(ctx, key_path, SSL_FILETYPE_PEM_) != 1 ||
      TLSA.SSL_CTX_check_private_key(ctx) != 1) {
    TLSA.SSL_CTX_free(ctx);
    return -EINVAL;
  }
  // SSL_write retries may pass a different (advanced) pointer after a
  // short write — both modes are required for ring-buffer flushing
  TLSA.SSL_CTX_ctrl(ctx, SSL_CTRL_MODE_,
                    SSL_MODE_ENABLE_PARTIAL_WRITE_ |
                        SSL_MODE_ACCEPT_MOVING_WRITE_BUFFER_,
                    nullptr);
  return (long long)(intptr_t)ctx;
}

int vtl_tls_ctx_free(long long ctx) {
  if (!TLSA.ready || !ctx) return -EINVAL;
  TLSA.SSL_CTX_free((SSL_CTX_*)(intptr_t)ctx);
  return 0;
}

// MSG_PEEK (the SNI sniffer reads the ClientHello without consuming it)
int vtl_recv_peek(int fd, void* buf, int len) {
  ssize_t n = recv(fd, buf, (size_t)len, MSG_PEEK);
  return n < 0 ? -errno : (int)n;
}

// ------------------------------------------------------------ pump engine

// Process-global pump counters (all loops/threads): total payload bytes
// moved, write syscalls issued, writes that moved fewer bytes than
// requested (incl. EAGAIN — the backpressure signal), and completed TLS
// handshakes. Exposed to Python through vtl_pump_counters() and
// surfaced on /metrics as vproxy_pump_*_total.
static std::atomic<uint64_t> g_pump_bytes(0), g_pump_writes(0),
    g_pump_short_writes(0), g_tls_handshakes(0);

static inline void count_write(ssize_t wrote, size_t wanted) {
  g_pump_writes.fetch_add(1, std::memory_order_relaxed);
  if (wrote > 0)
    g_pump_bytes.fetch_add((uint64_t)wrote, std::memory_order_relaxed);
  if (wrote < (ssize_t)wanted)
    g_pump_short_writes.fetch_add(1, std::memory_order_relaxed);
}

// out[0]=bytes, out[1]=write calls, out[2]=short writes, out[3]=tls
// handshakes; returns 4 (the counter count)
int vtl_pump_counters(uint64_t* out) {
  out[0] = g_pump_bytes.load(std::memory_order_relaxed);
  out[1] = g_pump_writes.load(std::memory_order_relaxed);
  out[2] = g_pump_short_writes.load(std::memory_order_relaxed);
  out[3] = g_tls_handshakes.load(std::memory_order_relaxed);
  return 4;
}

static void pump_update_interest(Loop* l, Pump* p);

static void pump_kill(Loop* l, Pump* p, int err) {
  if (p->dead) return;
  p->dead = true;
  p->err = err;
  if (p->ssl) {
    TLSA.SSL_free((SSL_*)p->ssl);  // does not close fd_a (SSL_set_fd)
    p->ssl = nullptr;
  }
  for (int fd : {p->fd_a, p->fd_b}) {
    auto it = l->handlers.find(fd);
    if (it != l->handlers.end()) {
      loop_detach(l, it->second);
      drop_handler(l, it->second);
      l->handlers.erase(it);
    }
    close(fd);
  }
  l->done_pumps.push_back(p->id);
}

// move bytes: read src->ring, write ring->dst. returns false on fatal
// error. peer_done = the opposite direction already hit EOF with its
// ring drained: the pump dies the moment THIS direction finishes, and
// the close() carries the FIN — the explicit shutdown would be a
// wasted syscall per short connection.
static bool pump_flow(Loop* l, Pump* p, int src, int dst, Ring& ring,
                      bool& src_eof, bool& dst_shut, uint64_t& counter,
                      bool peer_done) {
  // write pending data first
  while (!ring.empty()) {
    size_t chunk = std::min(ring.size, ring.cap() - ring.head);
    ssize_t n = write(dst, ring.buf.data() + ring.head, chunk);
    count_write(n, chunk);
    if (n > 0) {
      ring.head = (ring.head + (size_t)n) % ring.cap();
      ring.size -= (size_t)n;
      counter += (uint64_t)n;
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else {
      pump_kill(l, p, errno ? errno : EPIPE);
      return false;
    }
  }
  // then refill from src
  while (!src_eof && !ring.full()) {
    size_t tail = (ring.head + ring.size) % ring.cap();
    size_t chunk = std::min(ring.free_(), ring.cap() - tail);
    ssize_t n = read(src, ring.buf.data() + tail, chunk);
    if (n > 0) {
      ring.size += (size_t)n;
      // opportunistic immediate write-through (zero-latency splice)
      while (!ring.empty()) {
        size_t c2 = std::min(ring.size, ring.cap() - ring.head);
        ssize_t w = write(dst, ring.buf.data() + ring.head, c2);
        count_write(w, c2);
        if (w > 0) {
          ring.head = (ring.head + (size_t)w) % ring.cap();
          ring.size -= (size_t)w;
          counter += (uint64_t)w;
        } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          break;
        } else {
          pump_kill(l, p, errno ? errno : EPIPE);
          return false;
        }
      }
    } else if (n == 0) {
      src_eof = true;
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      break;
    } else {
      pump_kill(l, p, errno);
      return false;
    }
  }
  // src closed and everything flushed -> propagate FIN (unless the
  // whole pump is about to die: close() sends it for free)
  if (src_eof && ring.empty() && !dst_shut) {
    if (!peer_done) shutdown(dst, SHUT_WR);
    dst_shut = true;
  }
  return true;
}

// ---- TLS-terminating pump: A = TLS client side (SSL owns the record
// layer over fd_a), B = plaintext backend. The same ring discipline as
// pump_flow, with SSL_read/SSL_write in place of read/write on A and
// WANT_READ/WANT_WRITE driving A's epoll interest (renegotiations and
// mid-write stalls included).

static void tls_update_interest(Loop* l, Pump* p);

// classify an SSL_* return: 0 = want/eof handled (flags set), -1 = killed
static int tls_err(Loop* l, Pump* p, int r, bool* eof_out,
                   bool* want_read, bool* want_write) {
  int e = TLSA.SSL_get_error((SSL_*)p->ssl, r);
  if (e == SSL_ERROR_WANT_READ_) {
    if (want_read) *want_read = true;
    return 0;
  }
  if (e == SSL_ERROR_WANT_WRITE_) {
    if (want_write) *want_write = true;
    return 0;
  }
  if (e == SSL_ERROR_ZERO_RETURN_ && eof_out) { *eof_out = true; return 0; }
  if (e == SSL_ERROR_SYSCALL_ && eof_out && (errno == 0 || r == 0)) {
    *eof_out = true;  // peer dropped without close_notify
    return 0;
  }
  pump_kill(l, p, e == SSL_ERROR_SYSCALL_ && errno ? errno : EPROTO);
  return -1;
}

static void tls_pump_run(Loop* l, Pump* p) {
  if (p->dead) return;
  p->rd_want_write = p->wr_want_read = p->wr_want_write = false;
  p->hs_want_write = false;
  TLSA.ERR_clear_error();
  SSL_* ssl = (SSL_*)p->ssl;
  if (p->handshaking) {
    int r = TLSA.SSL_do_handshake(ssl);
    if (r == 1) {
      p->handshaking = false;
      g_tls_handshakes.fetch_add(1, std::memory_order_relaxed);
    } else {
      bool dummy = false;
      if (tls_err(l, p, r, nullptr, &dummy, &p->hs_want_write) < 0) return;
      tls_update_interest(l, p);
      return;
    }
  }
  // flush decrypted a2b -> B
  Ring& ab = p->a2b;
  while (!ab.empty()) {
    size_t chunk = std::min(ab.size, ab.cap() - ab.head);
    ssize_t n = write(p->fd_b, ab.buf.data() + ab.head, chunk);
    count_write(n, chunk);
    if (n > 0) {
      ab.head = (ab.head + (size_t)n) % ab.cap();
      ab.size -= (size_t)n;
      p->bytes_a2b += (uint64_t)n;
    } else if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      break;
    } else {
      pump_kill(l, p, errno ? errno : EPIPE);
      return;
    }
  }
  // SSL_read A -> a2b (with plaintext write-through to B)
  while (!p->a_eof && !ab.full()) {
    size_t tail = (ab.head + ab.size) % ab.cap();
    size_t chunk = std::min(ab.free_(), ab.cap() - tail);
    int n = TLSA.SSL_read(ssl, ab.buf.data() + tail, (int)chunk);
    if (n > 0) {
      ab.size += (size_t)n;
      while (!ab.empty()) {
        size_t c2 = std::min(ab.size, ab.cap() - ab.head);
        ssize_t w = write(p->fd_b, ab.buf.data() + ab.head, c2);
        count_write(w, c2);
        if (w > 0) {
          ab.head = (ab.head + (size_t)w) % ab.cap();
          ab.size -= (size_t)w;
          p->bytes_a2b += (uint64_t)w;
        } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
          break;
        } else {
          pump_kill(l, p, errno ? errno : EPIPE);
          return;
        }
      }
    } else {
      bool dummy = false;
      if (tls_err(l, p, n, &p->a_eof, &dummy, &p->rd_want_write) < 0)
        return;
      break;  // WANT_READ here is the normal no-more-records state
    }
  }
  if (p->a_eof && ab.empty() && !p->b_wr_shut) {
    shutdown(p->fd_b, SHUT_WR);
    p->b_wr_shut = true;
  }
  // flush b2a -> SSL_write A
  Ring& ba = p->b2a;
  while (!ba.empty() && !p->wr_want_read && !p->wr_want_write) {
    size_t chunk = std::min(ba.size, ba.cap() - ba.head);
    int n = TLSA.SSL_write(ssl, ba.buf.data() + ba.head, (int)chunk);
    count_write(n, chunk);
    if (n > 0) {
      ba.head = (ba.head + (size_t)n) % ba.cap();
      ba.size -= (size_t)n;
      p->bytes_b2a += (uint64_t)n;
    } else {
      if (tls_err(l, p, n, nullptr, &p->wr_want_read,
                  &p->wr_want_write) < 0)
        return;
      break;
    }
  }
  // read B -> b2a (with SSL_write-through); the ring gives backpressure
  while (!p->b_eof && !ba.full()) {
    size_t tail = (ba.head + ba.size) % ba.cap();
    size_t chunk = std::min(ba.free_(), ba.cap() - tail);
    ssize_t n = read(p->fd_b, ba.buf.data() + tail, chunk);
    if (n > 0) {
      ba.size += (size_t)n;
      while (!ba.empty() && !p->wr_want_read && !p->wr_want_write) {
        size_t c2 = std::min(ba.size, ba.cap() - ba.head);
        int w = TLSA.SSL_write(ssl, ba.buf.data() + ba.head, (int)c2);
        count_write(w, c2);
        if (w > 0) {
          ba.head = (ba.head + (size_t)w) % ba.cap();
          ba.size -= (size_t)w;
          p->bytes_b2a += (uint64_t)w;
        } else {
          if (tls_err(l, p, w, nullptr, &p->wr_want_read,
                      &p->wr_want_write) < 0)
            return;
          break;
        }
      }
    } else if (n == 0) {
      p->b_eof = true;
    } else if (errno == EAGAIN || errno == EWOULDBLOCK) {
      break;
    } else {
      pump_kill(l, p, errno);
      return;
    }
  }
  if (p->b_eof && ba.empty() && !p->a_wr_shut) {
    TLSA.SSL_shutdown(ssl);  // close_notify (best effort, nonblocking)
    shutdown(p->fd_a, SHUT_WR);
    p->a_wr_shut = true;
  }
  if (p->a_eof && p->b_eof && ab.empty() && ba.empty()) {
    pump_kill(l, p, 0);
    return;
  }
  tls_update_interest(l, p);
}

static void tls_update_interest(Loop* l, Pump* p) {
  auto ha = l->handlers.find(p->fd_a);
  auto hb = l->handlers.find(p->fd_b);
  if (ha == l->handlers.end() || hb == l->handlers.end()) return;
  uint32_t ia = 0, ib = 0;
  if (p->handshaking) {
    ia = p->hs_want_write ? VTL_EV_WRITE : VTL_EV_READ;
  } else {
    if (p->wr_want_read || (!p->a_eof && !p->a2b.full()))
      ia |= VTL_EV_READ;
    if (p->rd_want_write || p->wr_want_write) ia |= VTL_EV_WRITE;
    if (!p->b_eof && !p->b2a.full()) ib |= VTL_EV_READ;
    if (!p->a2b.empty()) ib |= VTL_EV_WRITE;
  }
  if (ha->second->interest != ia) ep_set(l, ha->second, ia);
  if (hb->second->interest != ib) ep_set(l, hb->second, ib);
}

static void pump_run(Loop* l, Pump* p) {
  if (p->dead) return;
  if (p->ssl) {
    tls_pump_run(l, p);
    return;
  }
  if (!pump_flow(l, p, p->fd_a, p->fd_b, p->a2b, p->a_eof, p->b_wr_shut,
                 p->bytes_a2b, p->b_eof && p->b2a.empty()))
    return;
  if (!pump_flow(l, p, p->fd_b, p->fd_a, p->b2a, p->b_eof, p->a_wr_shut,
                 p->bytes_b2a, p->a_eof && p->a2b.empty()))
    return;
  if (p->a_eof && p->b_eof && p->a2b.empty() && p->b2a.empty()) {
    pump_kill(l, p, 0);
    return;
  }
  pump_update_interest(l, p);
}

static void pump_update_interest(Loop* l, Pump* p) {
  auto ha = l->handlers.find(p->fd_a);
  auto hb = l->handlers.find(p->fd_b);
  if (ha == l->handlers.end() || hb == l->handlers.end()) return;
  uint32_t ia = 0, ib = 0;
  if (!p->a_eof && !p->a2b.full()) ia |= VTL_EV_READ;
  if (!p->b2a.empty()) ia |= VTL_EV_WRITE;
  if (!p->b_eof && !p->b2a.full()) ib |= VTL_EV_READ;
  if (!p->a2b.empty()) ib |= VTL_EV_WRITE;
  if (ha->second->interest != ia) ep_set(l, ha->second, ia);
  if (hb->second->interest != ib) ep_set(l, hb->second, ib);
}

// connect-failure teardown: like pump_kill but fd_a stays OPEN and
// unregistered — the python retry layer owns the client fd again and
// either re-dials another backend or closes it.
static void pump_fail_connect(Loop* l, Pump* p, int err) {
  if (p->dead) return;
  p->dead = true;
  p->err = err;
  p->connect_failed = true;
  {  // fd_a stays OPEN for the retry layer: a real DEL is required
    auto it = l->handlers.find(p->fd_a);
    if (it != l->handlers.end()) {
      if (it->second->interest != (uint32_t)-1) loop_detach(l, it->second);
      drop_handler(l, it->second);
      l->handlers.erase(it);
    }
  }
  {
    auto it = l->handlers.find(p->fd_b);
    if (it != l->handlers.end()) {
      loop_detach(l, it->second);
      drop_handler(l, it->second);
      l->handlers.erase(it);
    }
  }
  close(p->fd_b);
  l->done_pumps.push_back(p->id);
}

static uint64_t mono_us() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000u + (uint64_t)(ts.tv_nsec / 1000);
}

static uint64_t mono_ns() {
  // CLOCK_MONOTONIC ns — the SAME clock python's time.monotonic_ns()
  // reads on linux, so C-plane and python-plane spans of one trace
  // order consistently without any epoch translation
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

static void pump_set_nodelay(int fd_a, int fd_b) {
  // both sockets, in C: two fewer python->C crossings per session than
  // the old explicit vtl_set_nodelay pair (non-TCP fds just ENOPROTOOPT)
  int one = 1;
  setsockopt(fd_a, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  setsockopt(fd_b, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

uint64_t vtl_pump_new(void* lp, int fd_a, int fd_b, int bufsize) {
  Loop* l = (Loop*)lp;
  if (l->handlers.count(fd_a) || l->handlers.count(fd_b)) return 0;
  pump_set_nodelay(fd_a, fd_b);
  uint64_t id = l->next_pump_id++;
  Pump* p = new Pump(id, fd_a, fd_b, (size_t)bufsize);
  Handler* ha = new Handler{Handler::PUMP_A, id, p, fd_a, (uint32_t)-1};
  Handler* hb = new Handler{Handler::PUMP_B, id, p, fd_b, (uint32_t)-1};
  l->handlers[fd_a] = ha;
  l->handlers[fd_b] = hb;
  l->valid.insert(ha);
  l->valid.insert(hb);
  l->pumps[id] = p;
  ep_set(l, ha, VTL_EV_READ);
  ep_set(l, hb, VTL_EV_READ);
  pump_run(l, p);  // kick: there may be buffered bytes ready to read
  return id;
}

// The accept fast lane: socket + TCP_NODELAY + nonblocking connect +
// pump registration in ONE python->C crossing (the python path costs
// ~8: tcp_connect, epoll add/mod x3, finish_connect, nodelay x2, pump).
// The pump idles until the connect resolves — the client's early bytes
// wait in the kernel, exactly like the python path's pause_reading —
// then splices as if vtl_pump_new had been called. A refused/unreachable
// backend surfaces as PUMP_DONE with the connect_failed flag
// (vtl_pump_stat2 out[3] bit0) and fd_a left open for the retry layer.
static uint64_t pump_connect_impl(Loop* l, int fd_a, const sockaddr* sa,
                                  socklen_t slen, int bufsize) {
  if (l->handlers.count(fd_a)) return 0;
  int v6 = sa->sa_family == AF_INET6;
  int fd_b = socket(v6 ? AF_INET6 : AF_INET,
                    SOCK_STREAM | SOCK_NONBLOCK | SOCK_CLOEXEC, 0);
  if (fd_b < 0) return 0;
  pump_set_nodelay(fd_a, fd_b);
  int r = connect(fd_b, sa, slen);
  if (r < 0 && errno != EINPROGRESS) {
    int saved = errno;
    close(fd_b);
    errno = saved;  // lanes report the sync refusal's errno in the punt
    return 0;  // sync refusal: caller falls back to the python path
  }
  uint64_t id = l->next_pump_id++;
  Pump* p = new Pump(id, fd_a, fd_b, (size_t)bufsize);
  p->b_connecting = (r < 0);
  p->created_us = mono_us();
  if (!p->b_connecting) p->connect_us = 0;  // resolved synchronously
  Handler* ha = new Handler{Handler::PUMP_A, id, p, fd_a, (uint32_t)-1};
  Handler* hb = new Handler{Handler::PUMP_B, id, p, fd_b, (uint32_t)-1};
  l->handlers[fd_a] = ha;
  l->handlers[fd_b] = hb;
  l->valid.insert(ha);
  l->valid.insert(hb);
  l->pumps[id] = p;
  if (p->b_connecting) {
    // fd_a stays UNREGISTERED until the backend resolves (its interest
    // is -1; the resolve path's ep_set does the ADD): one epoll_ctl
    // fewer per session, and the client's early bytes wait in the
    // kernel either way. A client RST mid-connect is noticed at
    // resolve time (read error) or the connect deadline — bounded.
    ep_set(l, hb, VTL_EV_WRITE);  // connect completion
  } else {  // loopback can complete synchronously
    ep_set(l, ha, VTL_EV_READ);
    ep_set(l, hb, VTL_EV_READ);
    pump_run(l, p);
  }
  return id;
}

uint64_t vtl_pump_connect(void* lp, int fd_a, const char* ip, int port,
                          int v6, int bufsize) {
  sockaddr_storage ss;
  socklen_t slen;
  if (mk_addr(ip, port, v6, &ss, &slen) < 0) return 0;
  return pump_connect_impl((Loop*)lp, fd_a, (sockaddr*)&ss, slen, bufsize);
}

// connect-timeout hook: if `id` is still mid-connect, fail it like a
// refused connect (DONE + connect_failed, fd_a kept). No-op otherwise.
int vtl_pump_abort_connect(void* lp, uint64_t id) {
  Loop* l = (Loop*)lp;
  auto it = l->pumps.find(id);
  if (it == l->pumps.end() || !it->second->b_connecting ||
      it->second->dead)
    return 0;
  pump_fail_connect(l, it->second, ETIMEDOUT);
  return 1;
}

// TLS-terminating pump: fd_tls speaks TLS (server role, handshake
// included — the ClientHello is still queued in the socket thanks to
// the MSG_PEEK sniffer), fd_plain is the backend. Same id space /
// stat / close / free / DONE notification as the plain pump.
uint64_t vtl_tls_pump_new(void* lp, int fd_tls, int fd_plain, int bufsize,
                          long long ctx) {
  if (!TLSA.ready || !ctx) return 0;
  Loop* l = (Loop*)lp;
  if (l->handlers.count(fd_tls) || l->handlers.count(fd_plain)) return 0;
  pump_set_nodelay(fd_tls, fd_plain);
  SSL_* ssl = TLSA.SSL_new((SSL_CTX_*)(intptr_t)ctx);
  if (!ssl) return 0;
  if (TLSA.SSL_set_fd(ssl, fd_tls) != 1) {
    TLSA.SSL_free(ssl);
    return 0;
  }
  TLSA.SSL_set_accept_state(ssl);
  uint64_t id = l->next_pump_id++;
  Pump* p = new Pump(id, fd_tls, fd_plain, (size_t)bufsize);
  p->ssl = ssl;
  p->handshaking = true;
  Handler* ha = new Handler{Handler::PUMP_A, id, p, fd_tls, (uint32_t)-1};
  Handler* hb = new Handler{Handler::PUMP_B, id, p, fd_plain, (uint32_t)-1};
  l->handlers[fd_tls] = ha;
  l->handlers[fd_plain] = hb;
  l->valid.insert(ha);
  l->valid.insert(hb);
  l->pumps[id] = p;
  ep_set(l, ha, VTL_EV_READ);
  ep_set(l, hb, VTL_EV_READ);
  pump_run(l, p);  // the peeked ClientHello is already readable
  return id;
}

// stats: out[0]=bytes_a2b, out[1]=bytes_b2a, out[2]=err, returns 0/-ENOENT
int vtl_pump_stat(void* lp, uint64_t id, uint64_t* out) {
  Loop* l = (Loop*)lp;
  auto it = l->pumps.find(id);
  if (it == l->pumps.end()) return -ENOENT;
  out[0] = it->second->bytes_a2b;
  out[1] = it->second->bytes_b2a;
  out[2] = (uint64_t)it->second->err;
  return 0;
}

// stat + flags: out[3] bit0 = connect_failed (vtl_pump_connect pumps
// whose backend never came up — fd_a is still open, python retries),
// bit1 = still mid-connect; out[4] = resolved backend-connect duration
// in us (0 when unresolved/unknown — callers gate on the flags)
int vtl_pump_stat2(void* lp, uint64_t id, uint64_t* out) {
  Loop* l = (Loop*)lp;
  auto it = l->pumps.find(id);
  if (it == l->pumps.end()) return -ENOENT;
  Pump* p = it->second;
  out[0] = p->bytes_a2b;
  out[1] = p->bytes_b2a;
  out[2] = (uint64_t)p->err;
  out[3] = (p->connect_failed ? 1u : 0u) | (p->b_connecting ? 2u : 0u);
  out[4] = p->connect_us == (uint64_t)-1 ? 0 : p->connect_us;
  return 0;
}

int vtl_pump_close(void* lp, uint64_t id) {
  Loop* l = (Loop*)lp;
  auto it = l->pumps.find(id);
  if (it == l->pumps.end()) return -ENOENT;
  pump_kill(l, it->second, 0);
  return 0;
}

// free a DONE pump's memory (after python saw VTL_EV_PUMP_DONE)
int vtl_pump_free(void* lp, uint64_t id) {
  Loop* l = (Loop*)lp;
  auto it = l->pumps.find(id);
  if (it == l->pumps.end()) return -ENOENT;
  if (!it->second->dead) pump_kill(l, it->second, 0);
  delete it->second;
  l->pumps.erase(it);
  return 0;
}

// ------------------------------------------------------------------ poll

int vtl_poll(void* lp, uint64_t* tags, uint32_t* evs, int max,
             int timeout_ms) {
  Loop* l = (Loop*)lp;
  for (Handler* g : l->garbage) delete g;
  l->garbage.clear();
  // deliver pending pump-done notifications first
  int out = 0;
  auto flush_done = [&]() {
    while (!l->done_pumps.empty() && out < max) {
      tags[out] = l->done_pumps.back();
      evs[out] = VTL_EV_PUMP_DONE;
      l->done_pumps.pop_back();
      ++out;
    }
  };
  flush_done();
  if (out > 0) return out;

  epoll_event eps[256];
  int cap = 256 < max ? 256 : max;
  int n = epoll_wait(l->ep, eps, cap, timeout_ms);
  if (n < 0) return errno == EINTR ? 0 : -errno;
  for (int i = 0; i < n; ++i) {
    Handler* h = (Handler*)eps[i].data.ptr;
    if (!l->valid.count(h)) continue;  // torn down earlier in this batch
    uint32_t e = eps[i].events;
    switch (h->kind) {
      case Handler::WAKE: {
        uint64_t v;
        while (read(l->wakefd, &v, 8) == 8) {}
        break;
      }
      case Handler::PY: {
        uint32_t ve = 0;
        if (e & (EPOLLIN | EPOLLHUP)) ve |= VTL_EV_READ;
        if (e & EPOLLOUT) ve |= VTL_EV_WRITE;
        if (e & EPOLLERR) ve |= VTL_EV_ERROR;
        if (ve && out < max) {
          tags[out] = h->tag;
          evs[out] = ve;
          ++out;
        }
        break;
      }
      case Handler::PUMP_A:
      case Handler::PUMP_B: {
        Pump* p = h->pump;
        if (h->kind == Handler::PUMP_B && p->b_connecting) {
          // fast-lane connect resolution: SO_ERROR decides. EPOLLHUP
          // with SO_ERROR==0 is a SUCCESSFUL connect whose peer already
          // closed (e.g. a draining backend shedding on accept) — that
          // must flow as a normal short session (EOF through the pump),
          // NOT as connect_failed: the python path treats the same
          // event as connected-then-closed, and a report_failure here
          // would feed a healthy backend's ejection streak.
          int err = 0;
          socklen_t elen = sizeof(err);
          getsockopt(h->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
          if (err) {
            pump_fail_connect(l, p, err);
          } else {
            p->b_connecting = false;
            p->connect_us = mono_us() - p->created_us;
            Handler* ha = l->handlers.count(p->fd_a)
                              ? l->handlers[p->fd_a] : nullptr;
            if (ha) ep_set(l, ha, VTL_EV_READ);
            ep_set(l, h, VTL_EV_READ);
            pump_run(l, p);  // early client bytes may already be queued
          }
          break;
        }
        if (e & EPOLLERR) {
          int err = 0;
          socklen_t elen = sizeof(err);
          getsockopt(h->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
          pump_kill(l, p, err ? err : EIO);
        } else {
          pump_run(l, p);
        }
        break;
      }
      default:
        break;  // LANE handlers never live on python loops
    }
  }
  flush_done();
  return out;
}

void vtl_free(void* lp) {
  Loop* l = (Loop*)lp;
  for (Handler* g : l->garbage) delete g;
  for (auto& kv : l->pumps) {
    if (!kv.second->dead) {  // live spliced sessions: close both fds
      if (kv.second->ssl) TLSA.SSL_free((SSL_*)kv.second->ssl);
      close(kv.second->fd_a);
      close(kv.second->fd_b);
    }
    delete kv.second;
  }
  for (auto& kv : l->handlers) delete kv.second;
  if (l->ur) uring_free(l->ur);
  if (l->ep >= 0) close(l->ep);
  if (l->wakefd >= 0) close(l->wakefd);
  delete l;
}

int vtl_errno_eagain() { return EAGAIN; }

// ------------------------------------------------------ switch flow cache
//
// The switch's repeat-flow fast lane (the Maglev/Ananta split: a slow
// "first packet" policy path in Python, a cached-flow path that never
// leaves C). vtl_switch_poll drains the switch's UDP socket with
// recvmmsg, probes an open-addressed exact-match flow table keyed on
// (sender, vni, eth_dst, eth_type, v4 src/dst/proto), and for hits
// applies the resolved action — raw forward, routed header rewrite
// (vni + macs + ttl-1 + RFC 1624 incremental checksum), or DROP with a
// reason — batching forwards into one sendmmsg per egress destination.
// Misses and non-fast frames are compacted into the caller's buffers
// exactly like vtl_recvmmsg output, so Python consumes them as a normal
// burst and (after classifying) installs entries via vtl_flow_install.
//
// Correctness is generation-gated: every route/ACL/MAC/ARP/iface
// mutation bumps the table's generation (vtl_switch_gen_bump, a single
// atomic — callable from any thread); entries carry the generation they
// were compiled under and a mismatched probe is a forced miss, so a
// rule change can never forward through a stale action. Entries also
// expire after a TTL and evict LRU-ish within the probe window.
// Table memory is only touched from the owning loop thread (poll +
// install both run there); only the generation atomic crosses threads.

// traffic-analytics knob + process tallies (the heavy-hitter plane,
// full machinery below at "traffic analytics"): the flow cache's
// per-entry hit tallies and the lanes' HH shards both gate on this one
// relaxed load — knob-off cost on every C hot path is exactly that.
static std::atomic<int> g_hh_on(0);
static std::atomic<uint64_t> g_hh_updates(0), g_hh_overflow(0);

// workload-capture knob: the accept lanes' inter-arrival and
// per-connection bytes/duration histograms gate on this one relaxed
// load, exactly like g_hh_on gates the HH shards — knob-off cost on
// the accept/reap paths is that single load. Python pushes it from
// utils/workload.configure() (same idiom as sketch.push_native_knob).
static std::atomic<int> g_wl_on(0);

// policing knob: the accept lanes' POLICE_REC probe gates on this
// one relaxed load — the knob-off cost per C site, exactly like g_hh_on
// gates the HH shards. Python pushes it from policing/engine.configure()
// (same idiom as sketch/workload push_native_knob).
static std::atomic<int> g_police_on(0);

#pragma pack(push, 1)
struct FlowKey {          // 26 bytes; must match vtl.py FLOW_REC prefix
  uint32_t sender_ip;     // host-order u32 of the v4 sender addr
  uint16_t sender_port;
  uint8_t vni[3];         // wire vni bytes (pre-override)
  uint8_t eth_dst[6];
  uint8_t eth_type[2];
  uint8_t ip_src[4];      // zeros unless v4/IHL=5 with a sane length
  uint8_t ip_dst[4];
  uint8_t proto;
};
struct FlowRec {          // install record; must match vtl.py FLOW_REC
  FlowKey key;
  uint8_t action;         // FC_ACT_*
  uint8_t flags;          // bit0 = routed rewrite
  uint8_t drop_reason;    // index into the shared drop-reason table
  uint8_t new_vni[3];     // effective/target vni to stamp on egress
  uint8_t new_dst[6];     // routed rewrite template
  uint8_t new_src[6];
  uint32_t out_ip;        // host-order u32 v4 egress addr (FC_ACT_FWD)
  uint16_t out_port;
  int32_t tap_fd;         // FC_ACT_TAP egress fd
};
#pragma pack(pop)
static_assert(sizeof(FlowKey) == 26, "FlowKey ABI drifted");
static_assert(sizeof(FlowRec) == 54, "FlowRec ABI drifted");

#define FC_ACT_EMPTY 0
#define FC_ACT_FWD 1
#define FC_ACT_TAP 2
#define FC_ACT_DROP 3
#define FC_FLAG_ROUTED 1u
// drop reasons (shared contract with net/vtl.py FLOW_DROP_REASONS):
// 0 acl_deny, 1 same_iface, 2 route_miss, 3 unknown_vni,
// 4 egress_short_write, 5 other
#define FC_DROP_REASONS 6
#define FC_R_EGRESS 4
#define FC_PROBE 8

struct FlowEntry {
  FlowKey key;
  uint8_t action, flags, drop_reason;
  uint8_t new_vni[3], new_dst[6], new_src[6];
  uint32_t out_ip;
  uint16_t out_port;
  int32_t tap_fd;
  uint64_t gen, expire_us, last_hit_us;
  // per-flow hit tally for the analytics plane (vtl_hh_flow_drain):
  // bumped by probe hits (atomic relaxed — N poller threads), drained
  // with exchange(0) by the switch's analytics tick. Like last_hit_us
  // it is mutated from both sides, so it is atomic everywhere.
  uint64_t hh_hits;
  // per-entry seqlock: the table is probed by N poller threads
  // (SO_REUSEPORT multiqueue) while the loop thread installs. Writers
  // (install only — probes never mutate entries beyond the benign
  // last_hit_us stat) bump to odd, write, bump to even; readers retry
  // as a miss on any seq movement. Entries are 1 writer / N readers.
  uint32_t seq;
};

struct FlowCache {
  std::vector<FlowEntry> slots;
  uint32_t mask = 0;
  uint64_t ttl_us = 0;
  std::atomic<uint64_t> gen{0};
  uint64_t used = 0;
  // maglev slot->candidate table (vtl_flow_maglev_install): loop-thread
  // only, like the slot vector — the compiler installs and picks from
  // the same thread that polls
  std::vector<int32_t> maglev;
  // per-table probe outcomes (the globals blend every switch in the
  // process; list-detail switch wants THIS switch's hit rate)
  std::atomic<uint64_t> hits{0}, misses{0};
  // vtl_hh_flow_drain's walk cursor (one caller by contract: the
  // owning switch's analytics tick)
  uint64_t hh_cursor = 0;
};

// process-global counters (all switches), pump_counters idiom
static std::atomic<uint64_t> g_fc_hit(0), g_fc_miss(0), g_fc_evict(0),
    g_fc_stale(0), g_fc_fwd(0);
static std::atomic<uint64_t> g_fc_drop[FC_DROP_REASONS];

// ------------- seqlock data plane: intentionally-racy, confined -------------
//
// The flow table is 1 writer (vtl_flow_install, the owning loop
// thread) / N readers (fc_probe on the SO_REUSEPORT poller threads).
// The seq word plus the fences carry all ordering; the entry PAYLOAD
// is read while the writer may be mid-write BY DESIGN — a torn read
// is discarded by the seq re-check that brackets the copy, and a
// discarded probe is a miss (always safe: Python re-decides). C++
// cannot express "benign under a seqlock" short of making every field
// atomic, so the racy accesses are confined to these two helpers and
// compiled without TSan instrumentation; everything OUTSIDE them
// operates on the consistent copy and stays fully checked (`make
// sanitize` + tests/test_sanitize.py, docs/static-analysis.md).
// last_hit_us is the one field mutated from BOTH sides (probes stamp
// hits, install reads it for LRU picks), so it is atomic everywhere.

// GCC defines __SANITIZE_THREAD__; clang spells it __has_feature
#if defined(__has_feature)
#if __has_feature(thread_sanitizer) && !defined(__SANITIZE_THREAD__)
#define __SANITIZE_THREAD__ 1
#endif
#endif
#if defined(__SANITIZE_THREAD__)
// noinline matters: inlined into an instrumented caller, the body
// would be re-instrumented and the annotation silently dropped
#define VTL_NO_TSAN __attribute__((no_sanitize("thread"), noinline))
#else
#define VTL_NO_TSAN
#endif

VTL_NO_TSAN static void fc_racy_copy(FlowEntry* out,
                                     const FlowEntry& e) {
#if defined(__SANITIZE_THREAD__)
  // volatile word loop: libc memcpy would report through the
  // annotation via the TSan interceptor (production keeps memcpy)
  const volatile unsigned char* s = (const volatile unsigned char*)&e;
  unsigned char* d = (unsigned char*)out;
  for (size_t i = 0; i < sizeof(FlowEntry); ++i) d[i] = s[i];
#else
  memcpy(out, &e, sizeof(FlowEntry));
#endif
}

VTL_NO_TSAN static void fc_racy_write(FlowEntry* dst, const FlowRec& rec,
                                      uint64_t gen, uint64_t now,
                                      uint64_t expire) {
  dst->key = rec.key;
  dst->action = rec.action;
  dst->flags = rec.flags;
  dst->drop_reason = rec.drop_reason < FC_DROP_REASONS
                         ? rec.drop_reason : FC_DROP_REASONS - 1;
  memcpy(dst->new_vni, rec.new_vni, 3);
  memcpy(dst->new_dst, rec.new_dst, 6);
  memcpy(dst->new_src, rec.new_src, 6);
  dst->out_ip = rec.out_ip;
  dst->out_port = rec.out_port;
  dst->tap_fd = rec.tap_fd;
  dst->gen = gen;
  dst->expire_us = expire;
  __atomic_store_n(&dst->last_hit_us, now, __ATOMIC_RELAXED);
  // a reused slot must not credit the new flow with the old flow's
  // pending analytics hits (one drain interval of misattribution)
  __atomic_store_n(&dst->hh_hits, 0ull, __ATOMIC_RELAXED);
}

static uint64_t fc_hash(const FlowKey& k) {
  const uint8_t* p = (const uint8_t*)&k;
  uint64_t h = 1469598103934665603ull;  // FNV-1a 64
  for (size_t i = 0; i < sizeof(FlowKey); ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

void* vtl_flowcache_new(int size, int ttl_ms) {
  uint32_t cap = 256;
  while (cap < (uint32_t)size && cap < (1u << 22)) cap <<= 1;
  FlowCache* fc = new FlowCache();
  fc->slots.assign(cap, FlowEntry());  // value-init: action == EMPTY
  fc->mask = cap - 1;
  fc->ttl_us = (uint64_t)(ttl_ms > 0 ? ttl_ms : 10000) * 1000u;
  return fc;
}

void vtl_flowcache_free(void* p) { delete (FlowCache*)p; }

void vtl_switch_gen_bump(void* p) {
  ((FlowCache*)p)->gen.fetch_add(1, std::memory_order_relaxed);
}

uint64_t vtl_switch_gen(void* p) {
  return ((FlowCache*)p)->gen.load(std::memory_order_relaxed);
}

int vtl_flow_rec_size(void) { return (int)sizeof(FlowRec); }

// out: hit, miss, evict, stale, fwd, drop[FC_DROP_REASONS]; -> count
int vtl_flowcache_counters(uint64_t* out) {
  out[0] = g_fc_hit.load(std::memory_order_relaxed);
  out[1] = g_fc_miss.load(std::memory_order_relaxed);
  out[2] = g_fc_evict.load(std::memory_order_relaxed);
  out[3] = g_fc_stale.load(std::memory_order_relaxed);
  out[4] = g_fc_fwd.load(std::memory_order_relaxed);
  for (int i = 0; i < FC_DROP_REASONS; ++i)
    out[5 + i] = g_fc_drop[i].load(std::memory_order_relaxed);
  return 5 + FC_DROP_REASONS;
}

// out[0]=capacity, out[1]=used slots, out[2]=generation,
// out[3]=hits, out[4]=misses (this table only); -> 5
int vtl_flowcache_stat(void* p, uint64_t* out) {
  FlowCache* fc = (FlowCache*)p;
  out[0] = fc->mask + 1;
  out[1] = fc->used;
  out[2] = fc->gen.load(std::memory_order_relaxed);
  out[3] = fc->hits.load(std::memory_order_relaxed);
  out[4] = fc->misses.load(std::memory_order_relaxed);
  return 5;
}

// Install n FlowRecs compiled by the Python fast path, stamped with the
// generation read BEFORE classification began: if anything mutated
// since, the whole batch is conservatively skipped (the flows re-miss
// and recompile against current tables). -> entries installed.
int vtl_flow_install(void* p, const void* recs, int n, uint64_t gen) {
  FlowCache* fc = (FlowCache*)p;
  uint64_t cur = fc->gen.load(std::memory_order_relaxed);
  if (gen != cur) return 0;
  uint64_t now = mono_us();
  const FlowRec* r = (const FlowRec*)recs;
  int installed = 0;
  for (int i = 0; i < n; ++i) {
    const FlowRec& rec = r[i];
    if (rec.action == FC_ACT_EMPTY) continue;
    uint64_t h = fc_hash(rec.key);
    FlowEntry *match = nullptr, *freeslot = nullptr, *lru = nullptr;
    for (int k = 0; k < FC_PROBE; ++k) {
      FlowEntry& e = fc->slots[(h + (uint64_t)k) & fc->mask];
      if (e.action == FC_ACT_EMPTY) {
        if (!freeslot) freeslot = &e;
        continue;
      }
      if (!memcmp(&e.key, &rec.key, sizeof(FlowKey))) {
        match = &e;
        break;
      }
      if (e.gen != cur || now >= e.expire_us) {
        if (!freeslot) freeslot = &e;
        continue;
      }
      // atomic: probes on other threads stamp last_hit_us on hits
      if (!lru || __atomic_load_n(&e.last_hit_us, __ATOMIC_RELAXED)
                      < __atomic_load_n(&lru->last_hit_us,
                                        __ATOMIC_RELAXED))
        lru = &e;
    }
    FlowEntry* dst = match ? match : (freeslot ? freeslot : lru);
    if (!dst) continue;
    if (!match && !freeslot)
      g_fc_evict.fetch_add(1, std::memory_order_relaxed);
    if (!match && freeslot && freeslot->action == FC_ACT_EMPTY) fc->used++;
    // seqlock write (install is the only entry mutator, loop thread)
    uint32_t s = __atomic_load_n(&dst->seq, __ATOMIC_RELAXED);
    __atomic_store_n(&dst->seq, s + 1, __ATOMIC_RELAXED);
    __atomic_thread_fence(__ATOMIC_SEQ_CST);
    fc_racy_write(dst, rec, gen, now, now + fc->ttl_us);
    __atomic_thread_fence(__ATOMIC_SEQ_CST);
    __atomic_store_n(&dst->seq, s + 2, __ATOMIC_RELEASE);
    ++installed;
  }
  return installed;
}

// Probe from any poller thread: copies the candidate entry out under
// its seqlock FIRST, then interprets only the consistent copy (any
// concurrent install movement degrades to a miss — safe, Python
// re-decides). Stale and expired entries are left for the install
// path to reclaim — readers never mutate table state beyond the
// atomic last_hit_us stat.
static bool fc_probe(FlowCache* fc, const FlowKey& key, uint64_t cur,
                     uint64_t now, FlowEntry* out) {
  uint64_t h = fc_hash(key);
  for (int k = 0; k < FC_PROBE; ++k) {
    FlowEntry& e = fc->slots[(h + (uint64_t)k) & fc->mask];
    uint32_t s1 = __atomic_load_n(&e.seq, __ATOMIC_ACQUIRE);
    if (s1 & 1) continue;  // mid-install: miss, reinstall will follow
    fc_racy_copy(out, e);  // seqlock-bracketed payload copy
    __atomic_thread_fence(__ATOMIC_ACQUIRE);
    if (__atomic_load_n(&e.seq, __ATOMIC_RELAXED) != s1)
      continue;  // THIS slot moved mid-copy (torn copy, untrusted):
                 // skip it — each slot's seqlock is independent, and
                 // the flow may live in a later, untouched slot
    if (out->action == FC_ACT_EMPTY) return false;
    if (memcmp(&out->key, &key, sizeof(FlowKey))) continue;
    if (out->gen != cur) {
      // the generation gate: a mutation since install forces a miss so
      // the Python policy path re-decides against current tables
      g_fc_stale.fetch_add(1, std::memory_order_relaxed);
      return false;
    }
    if (now >= out->expire_us) return false;
    __atomic_store_n(&e.last_hit_us, now, __ATOMIC_RELAXED);
    if (g_hh_on.load(std::memory_order_relaxed))
      __atomic_fetch_add(&e.hh_hits, 1ull, __ATOMIC_RELAXED);
    return true;
  }
  return false;
}

static bool fc_ip4_csum_ok(const uint8_t* b) {
  uint32_t s = 0;
  for (int k = 0; k < 20; k += 2)
    s += ((uint32_t)b[22 + k] << 8) | b[23 + k];
  s = (s & 0xFFFF) + (s >> 16);
  s = (s & 0xFFFF) + (s >> 16);
  return s == 0xFFFF;
}

// The native forwarding loop: drain recvmmsg from the switch's UDP
// socket, forward/drop flow-table hits entirely in C, return misses in
// vtl_recvmmsg's output format (compacted to the front of the buffers).
// Returns the miss count; *drained = total datagrams consumed from the
// socket this call (hits + drops + misses). Loops until the socket is
// dry, a batch contains misses (those must reach Python in arrival
// order before we read more), or a 1024-datagram budget (the Python
// loop keeps calling while progress is made).
int vtl_switch_poll(void* fcp, int fd, void* buf, int slot, int maxmsgs,
                    int* lens, char* ips, int ipstride, int* ports,
                    int* drained) {
  FlowCache* fc = (FlowCache*)fcp;
  if (maxmsgs > 512) maxmsgs = 512;
  static thread_local mmsghdr hdrs[512];
  static thread_local iovec iovs[512];
  static thread_local sockaddr_storage addrs[512];
  static thread_local mmsghdr ehdrs[512];
  static thread_local iovec eiovs[512];
  uint64_t now = mono_us();
  int total = 0;
  *drained = 0;
  while (total < 1024) {
    // re-read per batch: a mutation landing mid-call (iface removal on
    // another thread) stops being forwarded within one recvmmsg round
    uint64_t cur = fc->gen.load(std::memory_order_relaxed);
    for (int i = 0; i < maxmsgs; ++i) {
      iovs[i].iov_base = (char*)buf + (size_t)i * slot;
      iovs[i].iov_len = (size_t)slot;
      memset(&hdrs[i].msg_hdr, 0, sizeof(msghdr));
      hdrs[i].msg_hdr.msg_iov = &iovs[i];
      hdrs[i].msg_hdr.msg_iovlen = 1;
      hdrs[i].msg_hdr.msg_name = &addrs[i];
      hdrs[i].msg_hdr.msg_namelen = sizeof(sockaddr_storage);
    }
    int n = recvmmsg(fd, hdrs, (unsigned)maxmsgs, MSG_DONTWAIT, nullptr);
    if (n < 0) {
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (total == 0) return -errno;
      break;
    }
    if (n == 0) break;
    total += n;
    int miss_idx[512];
    int nmiss = 0;
    struct Dest { uint32_t ip; uint16_t port; };
    Dest dests[64];
    int ndests = 0;
    struct Out { uint8_t* p; size_t len; int dest; };
    Out outs[512];
    int nouts = 0;
    for (int i = 0; i < n; ++i) {
      uint8_t* b = (uint8_t*)buf + (size_t)i * slot;
      int ln = (int)hdrs[i].msg_len;
      bool probed = false, consumed = false;
      // fast-eligible: a bare VXLAN frame (flags byte + reserved zeros,
      // big enough to carry eth+ipv4) from a v4 sender — everything
      // else (encrypted user frames, v6 senders, runts) goes to Python
      if (ln >= 42 && (b[0] & 0x08) && !b[1] && !b[2] &&
          addrs[i].ss_family == AF_INET) {
        probed = true;
        auto* sa = (sockaddr_in*)&addrs[i];
        FlowKey key;
        memset(&key, 0, sizeof(key));
        key.sender_ip = ntohl(sa->sin_addr.s_addr);
        key.sender_port = ntohs(sa->sin_port);
        memcpy(key.vni, b + 4, 3);
        memcpy(key.eth_dst, b + 8, 6);
        memcpy(key.eth_type, b + 20, 2);
        int ip_total = 0;
        if (b[20] == 0x08 && b[21] == 0x00 && b[22] == 0x45) {
          ip_total = (b[24] << 8) | b[25];
          if (ip_total >= 20 && ln >= 22 + ip_total) {
            memcpy(key.ip_src, b + 34, 4);
            memcpy(key.ip_dst, b + 38, 4);
            key.proto = b[31];
          } else {
            ip_total = 0;  // key stays zero-filled, like the compiler's
          }
        }
        FlowEntry ecopy;
        FlowEntry* e = fc_probe(fc, key, cur, now, &ecopy) ? &ecopy
                                                           : nullptr;
        if (e) {
          if (e->action == FC_ACT_DROP) {
            g_fc_drop[e->drop_reason].fetch_add(
                1, std::memory_order_relaxed);
            consumed = true;
          } else if ((e->flags & FC_FLAG_ROUTED) &&
                     (b[30] <= 1 || !fc_ip4_csum_ok(b))) {
            // ttl expiry (ICMP time-exceeded) and corrupt headers are
            // Python's: the object path answers/recomputes for parity
          } else {
            int outlen = ln;
            memcpy(b + 4, e->new_vni, 3);
            if (e->flags & FC_FLAG_ROUTED) {
              memcpy(b + 8, e->new_dst, 6);
              memcpy(b + 14, e->new_src, 6);
              b[30] -= 1;
              // RFC 1624 incremental update for the ttl decrement
              uint32_t c = ((uint32_t)b[32] << 8) | b[33];
              uint32_t x = (c ^ 0xFFFFu) + 0xFEFFu;
              x = (x & 0xFFFF) + (x >> 16);
              x = (x & 0xFFFF) + (x >> 16);
              c = x ^ 0xFFFFu;
              b[32] = (uint8_t)(c >> 8);
              b[33] = (uint8_t)(c & 0xFF);
              outlen = 22 + ip_total;  // the object path trims trailers
            }
            if (e->action == FC_ACT_TAP) {
              ssize_t w = write(e->tap_fd, b + 8, (size_t)(outlen - 8));
              if (w < 0)
                g_fc_drop[FC_R_EGRESS].fetch_add(
                    1, std::memory_order_relaxed);
              else
                g_fc_fwd.fetch_add(1, std::memory_order_relaxed);
              consumed = true;
            } else {
              int d = -1;
              for (int k = 0; k < ndests; ++k)
                if (dests[k].ip == e->out_ip &&
                    dests[k].port == e->out_port) {
                  d = k;
                  break;
                }
              if (d < 0 && ndests < 64) {
                dests[ndests].ip = e->out_ip;
                dests[ndests].port = e->out_port;
                d = ndests++;
              }
              if (d >= 0) {
                outs[nouts].p = b;
                outs[nouts].len = (size_t)outlen;
                outs[nouts].dest = d;
                ++nouts;
                consumed = true;
              }
              // >64 destinations in one batch: fall through as a miss,
              // Python's grouped egress handles it (never drop silently)
            }
          }
        }
      }
      if (consumed) {
        g_fc_hit.fetch_add(1, std::memory_order_relaxed);
        fc->hits.fetch_add(1, std::memory_order_relaxed);
      } else {
        if (probed) {
          g_fc_miss.fetch_add(1, std::memory_order_relaxed);
          fc->misses.fetch_add(1, std::memory_order_relaxed);
        }
        miss_idx[nmiss++] = i;
      }
    }
    // grouped egress: ONE sendmmsg per destination. Must flush before
    // the next recvmmsg round overwrites the datagram buffers.
    for (int d = 0; d < ndests; ++d) {
      sockaddr_in sa;
      memset(&sa, 0, sizeof(sa));
      sa.sin_family = AF_INET;
      sa.sin_addr.s_addr = htonl(dests[d].ip);
      sa.sin_port = htons(dests[d].port);
      int m = 0;
      for (int j = 0; j < nouts; ++j) {
        if (outs[j].dest != d) continue;
        eiovs[m].iov_base = outs[j].p;
        eiovs[m].iov_len = outs[j].len;
        memset(&ehdrs[m].msg_hdr, 0, sizeof(msghdr));
        ehdrs[m].msg_hdr.msg_iov = &eiovs[m];
        ehdrs[m].msg_hdr.msg_iovlen = 1;
        ehdrs[m].msg_hdr.msg_name = &sa;
        ehdrs[m].msg_hdr.msg_namelen = sizeof(sa);
        ++m;
      }
      int sent = sendmmsg(fd, ehdrs, (unsigned)m, 0);
      if (sent < 0) sent = 0;
      if (sent > 0) g_fc_fwd.fetch_add((uint64_t)sent,
                                       std::memory_order_relaxed);
      if (sent < m)  // datagram backpressure: dropped, and counted
        g_fc_drop[FC_R_EGRESS].fetch_add((uint64_t)(m - sent),
                                         std::memory_order_relaxed);
    }
    if (nmiss) {
      // compact misses into the caller's vtl_recvmmsg-shaped output;
      // inet_ntop only runs for misses (hits never pay it)
      for (int j = 0; j < nmiss; ++j) {
        int i = miss_idx[j];
        if (j != i)
          memmove((char*)buf + (size_t)j * slot,
                  (char*)buf + (size_t)i * slot, hdrs[i].msg_len);
        lens[j] = (int)hdrs[i].msg_len;
        char* ip = ips + (size_t)j * ipstride;
        ip[0] = 0;
        ports[j] = 0;
        if (addrs[i].ss_family == AF_INET) {
          auto* a = (sockaddr_in*)&addrs[i];
          inet_ntop(AF_INET, &a->sin_addr, ip, ipstride);
          ports[j] = ntohs(a->sin_port);
        } else if (addrs[i].ss_family == AF_INET6) {
          auto* a = (sockaddr_in6*)&addrs[i];
          inet_ntop(AF_INET6, &a->sin6_addr, ip, ipstride);
          ports[j] = ntohs(a->sin6_port);
        }
      }
      *drained = total;
      return nmiss;
    }
    if (n < maxmsgs) break;  // socket likely dry
  }
  *drained = total;
  return 0;
}

// ------------------------------------------------------ maglev lookup
//
// Maglev consistent-hash pick (Eisenbud NSDI'16): Python compiles the
// permutation-fill slot->backend table (rules/maglev.py) and installs
// it C-resident; the hot-path pick is one FNV-1a 64 over the client
// address bytes (+ port, big-endian, when per-connection spread is
// wanted — hash_port=0 is source affinity) and one table load. The
// SAME hash runs in rules/maglev.py and on the device gather column;
// tests/test_maglev.py proves all three planes pick identically.

static uint64_t maglev_fnv64(const uint8_t* p, size_t n) {
  // FNV-1a 64 with the REAL offset basis 0xCBF29CE484222325 — NOT
  // fc_hash's (that constant dropped a digit; harmless for an internal
  // table hash, fatal for the cross-plane pick parity contract with
  // rules/maglev.fnv64 and the device column)
  uint64_t h = 14695981039346656037ull;
  for (size_t i = 0; i < n; ++i) {
    h ^= p[i];
    h *= 1099511628211ull;
  }
  return h;
}

static int32_t maglev_lookup(const int32_t* tab, int m, const uint8_t* ip,
                             int iplen, int port, int hash_port) {
  if (!tab || m <= 0 || iplen <= 0 || iplen > 16) return -1;
  uint8_t buf[18];
  memcpy(buf, ip, (size_t)iplen);
  size_t n = (size_t)iplen;
  if (hash_port) {
    buf[n++] = (uint8_t)((port >> 8) & 0xFF);
    buf[n++] = (uint8_t)(port & 0xFF);
  }
  return tab[maglev_fnv64(buf, n) % (uint64_t)m];
}

// the parity surface: tests (and any host-side caller) pick through the
// EXACT code path the lanes use
int vtl_maglev_pick(const int32_t* table, int m, const void* ip, int iplen,
                    int port, int hash_port) {
  return maglev_lookup(table, m, (const uint8_t*)ip, iplen, port,
                       hash_port);
}

// sockaddr -> (raw addr bytes, port) for the pick; false for families
// with no address to hash (AF_UNIX)
static bool maglev_addr_bytes(const sockaddr_storage* ss, uint8_t* out,
                              int* iplen, int* port) {
  if (ss->ss_family == AF_INET) {
    auto* a = (const sockaddr_in*)ss;
    memcpy(out, &a->sin_addr, 4);  // network order == parse_ip bytes
    *iplen = 4;
    *port = ntohs(a->sin_port);
    return true;
  }
  if (ss->ss_family == AF_INET6) {
    auto* a = (const sockaddr_in6*)ss;
    memcpy(out, &a->sin6_addr, 16);
    *iplen = 16;
    *port = ntohs(a->sin6_port);
    return true;
  }
  return false;
}

// -------------------------------------- flow-cache maglev table attach
//
// The switch flow cache's consistent-rehash primitive: a flow compiler
// can install the current generation's slot table and pick egress
// candidates through it, so conntrack-free flows that re-miss after a
// mutation (generation bump) rehash to the SAME destination unless the
// destination set itself changed. Today's switch flow entries carry a
// single resolved destination (no pick to make), so the live compiler
// does not attach a table yet — this is the ABI the conntrack/NAT/DSR
// roadmap item picks through (parity-tested in tests/test_maglev.py).
// Install is generation-gated exactly like vtl_flow_install (a raced
// bump skips the install wholesale); both calls run on the owning loop
// thread per the flow cache's threading contract.

int vtl_flow_maglev_install(void* p, const int32_t* table, int m,
                            uint64_t gen) {
  FlowCache* fc = (FlowCache*)p;
  if (m < 0) return -EINVAL;
  if (gen != fc->gen.load(std::memory_order_relaxed)) return 0;
  fc->maglev.assign(table, table + m);
  return m;
}

int vtl_flow_maglev_pick(void* p, const void* ip, int iplen, int port,
                         int hash_port) {
  FlowCache* fc = (FlowCache*)p;
  if (fc->maglev.empty()) return -1;
  return maglev_lookup(fc->maglev.data(), (int)fc->maglev.size(),
                       (const uint8_t*)ip, iplen, port, hash_port);
}

// ------------------------------------------------------- io_uring engine
//
// The accept lanes' batched-completion engine. The ABI structs and
// syscall numbers are defined HERE (not via <linux/io_uring.h>): this
// container's 4.4-era kernel headers predate io_uring entirely, and the
// build must produce BOTH engine paths everywhere — the runtime probe
// (vtl_uring_probe) decides which one actually runs. Compiling with
// -DVTL_NO_URING compiles the engine out (probe reports 0, lanes run
// epoll) — the build guard compiles both configurations.
//
// Engine shape: one ring per lane. Readiness is delivered as oneshot
// IORING_OP_POLL_ADD completions (re-armed per interest change), new
// connections via multishot IORING_OP_ACCEPT (EINVAL falls back to
// poll+accept4), and each lane_poll round is ONE io_uring_enter that
// both submits every queued SQE (poll re-arms, cancels, the accept
// re-arm) and reaps the whole completion batch — replacing
// epoll_wait + one epoll_ctl syscall per interest flip. Splice/send-zc
// opcodes are probed and reported (BENCH honesty) but the data path
// keeps the shared ring-buffer pump; offloading it onto SPLICE/SEND_ZC
// SQEs is future work, documented in docs/perf.md.

#pragma pack(push, 1)
struct vtl_uring_sqe {
  uint8_t opcode, flags;
  uint16_t ioprio;       // IORING_ACCEPT_MULTISHOT rides here
  int32_t fd;
  uint64_t off;          // TIMEOUT: completion count
  uint64_t addr;         // POLL_REMOVE/ASYNC_CANCEL: target user_data
  uint32_t len;
  uint32_t op_flags;     // poll_events / accept_flags / timeout_flags
  uint64_t user_data;
  uint16_t buf_index, personality;
  int32_t splice_fd_in;
  uint64_t pad2[2];
};
struct vtl_uring_cqe { uint64_t user_data; int32_t res; uint32_t flags; };
struct vtl_io_sqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, flags, dropped, array,
      resv1;
  uint64_t resv2;
};
struct vtl_io_cqring_offsets {
  uint32_t head, tail, ring_mask, ring_entries, overflow, cqes, flags,
      resv1;
  uint64_t resv2;
};
struct vtl_io_uring_params {
  uint32_t sq_entries, cq_entries, flags, sq_thread_cpu, sq_thread_idle,
      features, wq_fd, resv[3];
  vtl_io_sqring_offsets sq_off;
  vtl_io_cqring_offsets cq_off;
};
struct vtl_uring_probe_op { uint8_t op, resv; uint16_t flags; uint32_t resv2; };
struct vtl_uring_probe_s {
  uint8_t last_op, ops_len;
  uint16_t resv;
  uint32_t resv2[3];
  vtl_uring_probe_op ops[64];
};
#pragma pack(pop)
static_assert(sizeof(vtl_uring_sqe) == 64, "io_uring sqe ABI drifted");
static_assert(sizeof(vtl_uring_cqe) == 16, "io_uring cqe ABI drifted");
static_assert(sizeof(vtl_io_uring_params) == 120,
              "io_uring params ABI drifted");

#define VTL_IORING_OFF_SQ_RING 0ULL
#define VTL_IORING_OFF_CQ_RING 0x8000000ULL
#define VTL_IORING_OFF_SQES 0x10000000ULL
#define VTL_IORING_ENTER_GETEVENTS 1u
#define VTL_IORING_FEAT_SINGLE_MMAP 1u
#define VTL_IORING_OP_POLL_ADD 6
#define VTL_IORING_OP_POLL_REMOVE 7
#define VTL_IORING_OP_TIMEOUT 11
#define VTL_IORING_OP_ACCEPT 13
#define VTL_IORING_OP_ASYNC_CANCEL 14
#define VTL_IORING_OP_CONNECT 16
#define VTL_IORING_OP_SPLICE 30
#define VTL_IORING_OP_SEND_ZC 47
#define VTL_IORING_ACCEPT_MULTISHOT 1u
#define VTL_IORING_CQE_F_MORE 2u
#define VTL_IORING_REGISTER_PROBE 8
#define VTL_IO_URING_OP_SUPPORTED 1u
#ifndef __NR_io_uring_setup
#define __NR_io_uring_setup 425
#endif
#ifndef __NR_io_uring_enter
#define __NR_io_uring_enter 426
#endif
#ifndef __NR_io_uring_register
#define __NR_io_uring_register 427
#endif

// user_data low bits tag the op; handlers come from new (>=8-aligned)
#define VTL_UTAG_POLL 0ull
#define VTL_UTAG_ACCEPT 1ull
#define VTL_UTAG_CANCEL 2ull
#define VTL_UTAG_TIMEOUT 3ull

#ifdef VTL_NO_URING

// probe bitmask: bit0 io_uring_setup works, bit1 ACCEPT, bit2 CONNECT,
// bit3 POLL_ADD, bit4 SPLICE, bit5 SEND_ZC
int vtl_uring_probe(void) { return 0; }
static Uring* uring_new(unsigned) { return nullptr; }
static void uring_free(Uring*) {}
static int uring_set_interest(Loop*, Handler* h, uint32_t interest) {
  h->interest = interest;
  return -ENOSYS;
}
static void uring_detach(Loop*, Handler*) {}

#else  // !VTL_NO_URING

struct Uring {
  int fd = -1;
  unsigned sq_entries = 0;
  unsigned *sq_head = nullptr, *sq_tail = nullptr, *sq_mask = nullptr,
           *sq_array = nullptr;
  unsigned *cq_head = nullptr, *cq_tail = nullptr, *cq_mask = nullptr;
  vtl_uring_sqe* sqes = nullptr;
  vtl_uring_cqe* cqes = nullptr;
  void *sq_ring = nullptr, *cq_ring = nullptr;
  size_t sq_ring_sz = 0, cq_ring_sz = 0, sqes_sz = 0;
  unsigned to_submit = 0;
  bool single_mmap = false;
};

static int sys_uring_setup(unsigned entries, vtl_io_uring_params* p) {
  return (int)syscall(__NR_io_uring_setup, entries, p);
}
static int sys_uring_enter(int fd, unsigned to_submit,
                           unsigned min_complete, unsigned flags) {
  return (int)syscall(__NR_io_uring_enter, fd, to_submit, min_complete,
                      flags, nullptr, (size_t)0);
}
static int sys_uring_register(int fd, unsigned op, void* arg, unsigned n) {
  return (int)syscall(__NR_io_uring_register, fd, op, arg, n);
}

int vtl_uring_probe(void) {
  static std::atomic<int> cached(-1);
  int c = cached.load(std::memory_order_relaxed);
  if (c >= 0) return c;
  int mask = 0;
  vtl_io_uring_params p;
  memset(&p, 0, sizeof(p));
  int fd = sys_uring_setup(4, &p);
  if (fd >= 0) {
    mask |= 1;
    vtl_uring_probe_s pr;
    memset(&pr, 0, sizeof(pr));
    if (sys_uring_register(fd, VTL_IORING_REGISTER_PROBE, &pr, 64) == 0) {
      auto sup = [&](unsigned op) {
        return op <= pr.last_op &&
               (pr.ops[op].flags & VTL_IO_URING_OP_SUPPORTED);
      };
      if (sup(VTL_IORING_OP_ACCEPT)) mask |= 2;
      if (sup(VTL_IORING_OP_CONNECT)) mask |= 4;
      if (sup(VTL_IORING_OP_POLL_ADD)) mask |= 8;
      if (sup(VTL_IORING_OP_SPLICE)) mask |= 16;
      if (sup(VTL_IORING_OP_SEND_ZC)) mask |= 32;
    }
    close(fd);
  }
  cached.store(mask, std::memory_order_relaxed);
  return mask;
}

static void uring_free(Uring* u) {
  if (!u) return;
  if (u->sqes && u->sqes != MAP_FAILED) munmap(u->sqes, u->sqes_sz);
  if (u->cq_ring && u->cq_ring != u->sq_ring) munmap(u->cq_ring, u->cq_ring_sz);
  if (u->sq_ring && u->sq_ring != MAP_FAILED) munmap(u->sq_ring, u->sq_ring_sz);
  if (u->fd >= 0) close(u->fd);
  delete u;
}

static Uring* uring_new(unsigned entries) {
  vtl_io_uring_params p;
  memset(&p, 0, sizeof(p));
  int fd = sys_uring_setup(entries, &p);
  if (fd < 0) return nullptr;
  Uring* u = new Uring();
  u->fd = fd;
  u->sq_entries = p.sq_entries;
  u->sq_ring_sz = p.sq_off.array + p.sq_entries * sizeof(uint32_t);
  u->cq_ring_sz = p.cq_off.cqes + p.cq_entries * sizeof(vtl_uring_cqe);
  u->single_mmap = (p.features & VTL_IORING_FEAT_SINGLE_MMAP) != 0;
  if (u->single_mmap)
    u->sq_ring_sz = u->cq_ring_sz = std::max(u->sq_ring_sz, u->cq_ring_sz);
  u->sq_ring = mmap(nullptr, u->sq_ring_sz, PROT_READ | PROT_WRITE,
                    MAP_SHARED | MAP_POPULATE, fd, VTL_IORING_OFF_SQ_RING);
  if (u->sq_ring == MAP_FAILED) { uring_free(u); return nullptr; }
  u->cq_ring = u->single_mmap
                   ? u->sq_ring
                   : mmap(nullptr, u->cq_ring_sz, PROT_READ | PROT_WRITE,
                          MAP_SHARED | MAP_POPULATE, fd,
                          VTL_IORING_OFF_CQ_RING);
  if (u->cq_ring == MAP_FAILED) { uring_free(u); return nullptr; }
  u->sqes_sz = p.sq_entries * sizeof(vtl_uring_sqe);
  u->sqes = (vtl_uring_sqe*)mmap(nullptr, u->sqes_sz,
                                 PROT_READ | PROT_WRITE,
                                 MAP_SHARED | MAP_POPULATE, fd,
                                 VTL_IORING_OFF_SQES);
  if (u->sqes == MAP_FAILED) { uring_free(u); return nullptr; }
  char* s = (char*)u->sq_ring;
  u->sq_head = (unsigned*)(s + p.sq_off.head);
  u->sq_tail = (unsigned*)(s + p.sq_off.tail);
  u->sq_mask = (unsigned*)(s + p.sq_off.ring_mask);
  u->sq_array = (unsigned*)(s + p.sq_off.array);
  char* c = (char*)u->cq_ring;
  u->cq_head = (unsigned*)(c + p.cq_off.head);
  u->cq_tail = (unsigned*)(c + p.cq_off.tail);
  u->cq_mask = (unsigned*)(c + p.cq_off.ring_mask);
  u->cqes = (vtl_uring_cqe*)(c + p.cq_off.cqes);
  return u;
}

// next free SQE (flushing the queue if the SQ ring is full); nullptr
// only when the kernel refuses to drain — callers degrade gracefully
static vtl_uring_sqe* uring_sqe(Loop* l) {
  Uring* u = l->ur;
  unsigned head = __atomic_load_n(u->sq_head, __ATOMIC_ACQUIRE);
  unsigned tail = *u->sq_tail;  // single producer: the lane thread
  if (tail - head >= u->sq_entries) {
    if (sys_uring_enter(u->fd, u->to_submit, 0, 0) >= 0) u->to_submit = 0;
    head = __atomic_load_n(u->sq_head, __ATOMIC_ACQUIRE);
    if (tail - head >= u->sq_entries) return nullptr;
  }
  unsigned idx = tail & *u->sq_mask;
  vtl_uring_sqe* e = &u->sqes[idx];
  memset(e, 0, sizeof(*e));
  u->sq_array[idx] = idx;
  __atomic_store_n(u->sq_tail, tail + 1, __ATOMIC_RELEASE);
  u->to_submit++;
  return e;
}

static int uring_arm_poll(Loop* l, Handler* h, uint16_t ev) {
  vtl_uring_sqe* e = uring_sqe(l);
  if (!e) return -EBUSY;
  e->opcode = VTL_IORING_OP_POLL_ADD;
  e->fd = h->fd;
  e->op_flags = (uint32_t)(ev | POLLERR | POLLHUP);
  e->user_data = (uint64_t)(uintptr_t)h | VTL_UTAG_POLL;
  h->poll_pending = true;
  h->pending_ev = ev;
  h->inflight++;
  return 0;
}

static int uring_set_interest(Loop* l, Handler* h, uint32_t interest) {
  h->interest = interest;
  if (h->kind == Handler::LANE && h->ms_accept)
    return 0;  // multishot accept IS the readiness source
  uint16_t ev = 0;
  if (interest & VTL_EV_READ) ev |= POLLIN;
  if (interest & VTL_EV_WRITE) ev |= POLLOUT;
  if (h->poll_pending) {
    if (h->pending_ev != ev) {
      // armed for the wrong events: cancel; the -ECANCELED completion
      // re-arms from the then-current interest
      vtl_uring_sqe* e = uring_sqe(l);
      if (!e) return -EBUSY;
      e->opcode = VTL_IORING_OP_POLL_REMOVE;
      e->addr = (uint64_t)(uintptr_t)h | VTL_UTAG_POLL;
      e->user_data = (uint64_t)(uintptr_t)h | VTL_UTAG_CANCEL;
      h->inflight++;
      h->pending_ev = ev;  // dedupe further same-target removes
    }
    return 0;
  }
  if (!ev) return 0;
  return uring_arm_poll(l, h, ev);
}

// before an fd closes: cancel its outstanding ring ops so the kernel
// drops the file reference (a closed fd with a live uring poll leaks)
static void uring_detach(Loop* l, Handler* h) {
  if (h->poll_pending) {
    vtl_uring_sqe* e = uring_sqe(l);
    if (e) {
      e->opcode = VTL_IORING_OP_POLL_REMOVE;
      e->addr = (uint64_t)(uintptr_t)h | VTL_UTAG_POLL;
      e->user_data = (uint64_t)(uintptr_t)h | VTL_UTAG_CANCEL;
      h->inflight++;
    }
  }
  if (h->ms_accept) {
    vtl_uring_sqe* e = uring_sqe(l);
    if (e) {
      e->opcode = VTL_IORING_OP_ASYNC_CANCEL;
      e->addr = (uint64_t)(uintptr_t)h | VTL_UTAG_ACCEPT;
      e->user_data = (uint64_t)(uintptr_t)h | VTL_UTAG_CANCEL;
      h->inflight++;
    }
  }
}

#endif  // VTL_NO_URING

// Block until fd is readable or timeout_ms passes — the poller
// threads' park (they call vtl_switch_poll on wake). ctypes releases
// the GIL for the duration, so N pollers wait/forward in parallel.
// -> 1 readable, 0 timeout, -errno.
int vtl_wait_readable(int fd, int timeout_ms) {
  pollfd p;
  p.fd = fd;
  p.events = POLLIN;
  p.revents = 0;
  int r = poll(&p, 1, timeout_ms);
  if (r < 0) return errno == EINTR ? 0 : -errno;
  if (r == 0) return 0;
  if (p.revents & (POLLERR | POLLNVAL)) return -EBADF;
  return 1;
}

// --------------------------------------------------------- span tracing
//
// Per-request tracing for the C accept plane (utils/trace.py is the
// process-wide collector). When sampling is on (vtl_trace_set_sample,
// 1-in-N), each sampled lane connection gets an EVEN trace id from one
// global atomic (python allocates odd ids — disjoint namespaces, no
// coordination) and its lifetime stages are written as fixed binary
// TraceRec records into the owning lane's lock-free SPSC span ring
// (producer = the lane thread, consumer = the python drain through
// vtl_trace_drain — one consumer per ring by contract). Ring overflow
// bumps a counter and drops the record: counted, never silent, never
// blocking the accept path. Knob-off cost is one relaxed atomic load
// per accept.

#pragma pack(push, 1)
struct TraceRec {  // must match net/vtl.py TRACE_REC
  uint64_t trace_id;
  uint64_t t_start_ns;  // CLOCK_MONOTONIC
  uint64_t dur_ns;
  uint64_t aux;         // span-dependent: bytes (splice), punt kind
  uint32_t lane;
  uint8_t span;         // TR_* below; contract with vtl.py TRACE_SPANS
  uint8_t flags;        // bit0 = connect_failed teardown
  uint16_t err;
};
#pragma pack(pop)
static_assert(sizeof(TraceRec) == 40, "TraceRec ABI drifted");

// span-id contract with net/vtl.py TRACE_SPANS (index == id)
#define TR_ACCEPT 0
#define TR_PICK 1
#define TR_CONNECT 2
#define TR_SPLICE 3
#define TR_CLOSE 4
#define TR_PUNT 5
#define TR_POLICE 6  // a policed rejection: aux = action code

static std::atomic<uint64_t> g_trace_sample(0);   // 0 = off, N = 1-in-N
static std::atomic<uint64_t> g_trace_next(2);     // even ids (python: odd)
static std::atomic<uint64_t> g_trace_spans(0), g_trace_drops(0);
static std::atomic<int> g_trace_ring_cap(8192);   // pow2; read at lanes_new

struct TraceRing {
  std::vector<TraceRec> buf;
  std::atomic<uint64_t> head{0}, tail{0};  // head consumer, tail producer
  uint64_t mask;
  explicit TraceRing(int cap) : buf((size_t)cap), mask((uint64_t)cap - 1) {}
};

static void tr_push(TraceRing* r, const TraceRec& rec) {
  uint64_t t = r->tail.load(std::memory_order_relaxed);
  uint64_t h = r->head.load(std::memory_order_acquire);
  if (t - h > r->mask) {  // full: count the drop, never block the lane
    g_trace_drops.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  r->buf[t & r->mask] = rec;
  r->tail.store(t + 1, std::memory_order_release);
  g_trace_spans.fetch_add(1, std::memory_order_relaxed);
}

int vtl_trace_rec_size(void) { return (int)sizeof(TraceRec); }

void vtl_trace_set_sample(unsigned long long n) {
  g_trace_sample.store(n, std::memory_order_relaxed);
}

// ring capacity for lanes created AFTER this call (tests shrink it to
// exercise overflow without thousands of connections); clamped pow2
void vtl_trace_set_ring_cap(int cap) {
  int c = 64;
  while (c < cap && c < (1 << 20)) c <<= 1;
  g_trace_ring_cap.store(c, std::memory_order_relaxed);
}

// out[0] = spans written (all rings), out[1] = ring-overflow drops
int vtl_trace_counters(uint64_t* out) {
  out[0] = g_trace_spans.load(std::memory_order_relaxed);
  out[1] = g_trace_drops.load(std::memory_order_relaxed);
  return 2;
}

// ----------------------------------------------------- traffic analytics
//
// Heavy-hitter shards for the C planes (utils/sketch.py is the
// process-wide sketch owner). Each accept lane owns one HHShard — a
// small open-addressed (hash, key, count) table the lane thread updates
// inline (client address + picked backend per accept, coalescing
// repeats between drains); the lane's OWN python thread drains it
// through vtl_hh_drain after each vtl_lane_poll return, so producer and
// consumer are the same OS thread — no locks, no atomics, no races by
// construction. The flow cache's per-entry hit tallies drain through
// vtl_hh_flow_drain the same HH_REC shape. A full probe window bumps
// the overflow counter and drops the update: counted, never silent,
// never blocking the accept path. ONE hash contract: maglev_fnv64
// (FNV-1a 64) over raw key bytes, exported as vtl_hh_hash so python
// parity is testable bit for bit.

// dim-id contract with net/vtl.py HH_DIMS (index == id)
#define HH_DIM_CLIENT 0
#define HH_DIM_BACKEND 1
#define HH_DIM_FLOW 2
#define HH_KEY_MAX 54
#define HH_SHARD_SLOTS 512  // pow2; per-lane, drained every poll tick
#define HH_PROBE 8

#pragma pack(push, 1)
struct HHRec {  // drain record; must match net/vtl.py HH_REC
  uint64_t count;
  uint32_t lane;
  uint8_t dim;   // HH_DIM_*; contract with vtl.py HH_DIMS
  uint8_t klen;
  char key[54];  // raw client addr bytes / "ip:port" / FlowKey bytes
};
#pragma pack(pop)
static_assert(sizeof(HHRec) == 68, "HHRec ABI drifted");

struct HHSlot {
  uint64_t hash = 0;
  uint64_t count = 0;
  uint8_t dim = 0, klen = 0;
  char key[HH_KEY_MAX];
};
struct HHShard {
  HHSlot slots[HH_SHARD_SLOTS];
};

int vtl_hh_rec_size(void) { return (int)sizeof(HHRec); }

void vtl_hh_set_enabled(int on) {
  g_hh_on.store(on ? 1 : 0, std::memory_order_relaxed);
}

void vtl_workload_set_enabled(int on) {
  g_wl_on.store(on ? 1 : 0, std::memory_order_relaxed);
}

// the parity surface: python's sketch.fnv64 must agree bit for bit
unsigned long long vtl_hh_hash(const void* p, int n) {
  return maglev_fnv64((const uint8_t*)p, (size_t)(n > 0 ? n : 0));
}

// out[0] = shard updates absorbed, out[1] = probe-window overflows
int vtl_hh_counters(uint64_t* out) {
  out[0] = g_hh_updates.load(std::memory_order_relaxed);
  out[1] = g_hh_overflow.load(std::memory_order_relaxed);
  return 2;
}

static void hh_shard_update(HHShard* sh, uint8_t dim, const void* key,
                            int klen, uint64_t w) {
  if (klen <= 0) return;
  if (klen > HH_KEY_MAX) klen = HH_KEY_MAX;  // truncate, both sides see
                                             // the same truncated key
  uint64_t h = maglev_fnv64((const uint8_t*)key, (size_t)klen) ^
               ((uint64_t)(dim + 1) << 56);
  if (!h) h = 1;
  for (int i = 0; i < HH_PROBE; ++i) {
    HHSlot& s = sh->slots[(h + (uint64_t)i) & (HH_SHARD_SLOTS - 1)];
    if (s.count == 0) {
      s.hash = h;
      s.dim = dim;
      s.klen = (uint8_t)klen;
      memcpy(s.key, key, (size_t)klen);
      s.count = w;
      g_hh_updates.fetch_add(w, std::memory_order_relaxed);
      return;
    }
    if (s.hash == h && s.dim == dim && s.klen == (uint8_t)klen &&
        !memcmp(s.key, key, (size_t)klen)) {
      s.count += w;
      g_hh_updates.fetch_add(w, std::memory_order_relaxed);
      return;
    }
  }
  // probe window full between two drains: drop THIS update, loudly
  g_hh_overflow.fetch_add(w, std::memory_order_relaxed);
}

// Drain one flow cache's pending per-entry hit tallies as HH_REC
// records keyed by the 26-byte FlowKey. Resumes its walk across calls
// (hh_cursor); one caller per cache by contract — the owning switch's
// analytics tick. Entry keys are read under the per-entry seqlock
// (fc_racy_copy) so a concurrent install never yields a torn key; a
// slot moving mid-read keeps its tally for the next tick.
int vtl_hh_flow_drain(void* fcp, void* out, int max) {
  FlowCache* fc = (FlowCache*)fcp;
  if (!fc || !out || max <= 0) return -EINVAL;
  HHRec* o = (HHRec*)out;
  int n = 0;
  uint32_t cap = fc->mask + 1;
  uint32_t step = 0;
  for (; step < cap && n < max; ++step) {
    FlowEntry& e = fc->slots[(fc->hh_cursor + step) & fc->mask];
    if (!__atomic_load_n(&e.hh_hits, __ATOMIC_RELAXED)) continue;
    uint32_t s1 = __atomic_load_n(&e.seq, __ATOMIC_ACQUIRE);
    if (s1 & 1) continue;  // mid-install: pick it up next tick
    FlowEntry copy;
    fc_racy_copy(&copy, e);
    __atomic_thread_fence(__ATOMIC_ACQUIRE);
    if (__atomic_load_n(&e.seq, __ATOMIC_RELAXED) != s1) continue;
    uint64_t pend = __atomic_exchange_n(&e.hh_hits, 0ull,
                                        __ATOMIC_RELAXED);
    if (!pend) continue;
    o[n].count = pend;
    o[n].lane = 0;
    o[n].dim = HH_DIM_FLOW;
    o[n].klen = (uint8_t)sizeof(FlowKey);
    memset(o[n].key, 0, HH_KEY_MAX);
    memcpy(o[n].key, &copy.key, sizeof(FlowKey));
    ++n;
  }
  fc->hh_cursor += step;
  return n;
}

// ---------------------------------------------------------- accept lanes
//
// The switch-poller idiom applied to TCP: N lane threads (plain
// Python threads parked inside vtl_lane_poll — ctypes releases the GIL)
// each own a SO_REUSEPORT listener and run the WHOLE short-connection
// lifetime in C: accept4 batch -> route lookup against the C-resident
// lane entry (the compiled backend set + WRR sequence Python installs)
// -> pump_connect_impl -> splice -> close. Python is the lane-entry
// COMPILER: only punts cross ctypes — connections the lane must not
// decide (no entry, stale generation, armed failpoints, overload) and
// backend-connect failures (fd_a intact, feeding the retry/ejection
// machinery exactly like vtl_pump_connect's connect_failed DONE).
//
// Correctness is generation-gated like the switch flow cache: every
// upstream/ACL/backend-health mutation bumps ONE atomic
// (vtl_lane_gen_bump, any thread); the installed entry is stamped with
// the generation read before compilation began, and a mismatched stamp
// is a forced punt — zero stale routing by construction.

#pragma pack(push, 1)
struct LaneRec {  // install record; must match net/vtl.py LANE_REC
  char ip[46];
  uint16_t port;
  uint8_t v6;
  uint8_t weight;  // informational (Python pre-expands the WRR seq)
};
struct LanePunt {  // punt record; must match net/vtl.py LANE_PUNT
  int32_t fd;
  int32_t kind;  // 0 classic (serve via Python), 1 connect_failed
  int32_t err;
  uint16_t cport, bport;
  char cip[46];
  char bip[46];
  uint64_t trace_id;  // 0 = unsampled; else python CONTINUES the trace
};
struct MaglevRec {  // maglev install record; must match net/vtl.py MAGLEV_REC
  char ip[46];
  uint16_t port;
  uint8_t v6;
  uint8_t weight;  // informational (the table already encodes weight)
};
struct PoliceRec {  // policing install record; must match net/vtl.py POLICE_REC
  uint64_t key_hash;    // fnv64 over the raw client addr bytes; 0 = unused
  uint32_t rate_mtok;   // refill rate, milli-tokens / second
  uint32_t burst_mtok;  // bucket capacity, milli-tokens
  uint8_t action;       // POLICE_ACT_*
  uint8_t dim;          // 0 = clients (the only lane-enforced dimension)
  uint8_t pad[2];
};
#pragma pack(pop)
static_assert(sizeof(LaneRec) == 50, "LaneRec ABI drifted");
static_assert(sizeof(LanePunt) == 116, "LanePunt ABI drifted");
static_assert(sizeof(MaglevRec) == 50, "MaglevRec ABI drifted");
static_assert(sizeof(PoliceRec) == 20, "PoliceRec ABI drifted");

// action-code contract with policing/engine.ACTIONS (index == id)
#define POLICE_ACT_MONITOR 0
#define POLICE_ACT_THROTTLE 1
#define POLICE_ACT_SHED 2

// One policed key's live bucket state. The spinlock serializes the
// debit read-modify-write across lane threads (the same client can
// land on every SO_REUSEPORT listener at once); contention is
// per-HOT-KEY, not per-accept, and the critical section is a handful
// of integer ops — a std::mutex per slot would dominate the table.
struct PoliceSlot {
  uint64_t key_hash = 0;  // 0 = empty (open addressing sentinel)
  uint32_t rate_mtok = 0, burst_mtok = 0;
  uint8_t action = POLICE_ACT_MONITOR;
  std::atomic<int> lk{0};
  int64_t level_mtok = 0;
  uint64_t t_ns = 0;
};

struct PoliceTable {  // immutable layout after install; slots mutate
  uint64_t gen = 0;   // generation stamp: mismatch = forced consult-miss
  std::vector<PoliceSlot> slots;  // power-of-two, <= 50% loaded
};

static PoliceSlot* police_find(PoliceTable* pt, uint64_t h) {
  if (!pt || pt->slots.empty() || !h) return nullptr;
  uint32_t cap = (uint32_t)pt->slots.size();
  uint32_t idx = (uint32_t)h & (cap - 1);
  for (uint32_t p = 0; p < cap; ++p, idx = (idx + 1) & (cap - 1)) {
    PoliceSlot& s = pt->slots[idx];
    if (!s.key_hash) return nullptr;  // empty slot ends the probe chain
    if (s.key_hash == h) return &s;
  }
  return nullptr;
}

// THE bucket law — integer milli-tokens against explicit monotonic ns,
// arithmetic mirrored statement-for-statement by python
// policing/engine.TokenBucket.debit (the C==python parity test drives
// both with the same timestamp sequence and asserts bit-equality).
// -> 1 in quota (token taken), 0 over quota.
static inline int police_debit(PoliceSlot& s, uint64_t now_ns) {
  while (s.lk.exchange(1, std::memory_order_acquire)) {}
  if (now_ns > s.t_ns) {
    // 128-bit product: rate * a minutes-long gap overflows u64 and the
    // python side (arbitrary precision) would not — parity demands care
    unsigned __int128 add =
        (unsigned __int128)s.rate_mtok * (now_ns - s.t_ns) /
        1000000000ull;
    uint64_t a = add > (unsigned __int128)s.burst_mtok
                     ? s.burst_mtok
                     : (uint64_t)add;
    int64_t lvl = s.level_mtok + (int64_t)a;
    s.level_mtok = lvl > (int64_t)s.burst_mtok ? (int64_t)s.burst_mtok
                                               : lvl;
    s.t_ns = now_ns;
  }
  int ok = 0;
  if (s.level_mtok >= 1000) {
    s.level_mtok -= 1000;
    ok = 1;
  }
  s.lk.store(0, std::memory_order_release);
  return ok;
}

#define LANE_PUNT_CLASSIC 0
#define LANE_PUNT_CONNECT_FAIL 1

struct LaneRoute {
  uint64_t gen = 0;
  std::vector<LaneRec> backends;
  std::vector<sockaddr_storage> addrs;  // pre-resolved: no per-accept
  std::vector<socklen_t> lens;          // string parsing on the hot path
  std::vector<int32_t> seq;             // WRR pick sequence
  // maglev slot->backend table (vtl_lane_maglev_install); when present
  // it IS the pick path (seq stays empty) — one hash + one load per
  // accept, hash_port=0 for source-affinity groups
  std::vector<int32_t> maglev;
  int maglev_hash_port = 1;
  // "ip:port" analytics keys, index-aligned with backends: precomputed
  // at install so the accept path's HH update is a hash + memcpy, not
  // a snprintf
  std::vector<std::string> bkeys;
};

struct ConnMeta {  // per live lane pump (owning lane thread only)
  std::shared_ptr<LaneRoute> route;
  int bidx;
  uint64_t last_total, last_ts_us;
  uint64_t trace_id = 0;   // 0 = unsampled
  uint64_t t_acc_ns = 0;   // accept stamp (stage totals + spans)
  uint64_t t_conn_ns = 0;  // connect-resolved stamp (splice span start)
};

struct Lanes;

struct Lane {
  Lanes* owner = nullptr;
  Loop* loop = nullptr;
  int idx = 0;
  int lfd = -1;
  Handler* lh = nullptr;
  bool listener_closed = false;
  std::deque<LanePunt> punt_q;
  std::unordered_map<uint64_t, ConnMeta> meta;
  uint64_t next_sweep_us = 0;
  TraceRing* tring = nullptr;  // SPSC span ring (this thread produces)
  HHShard* hh = nullptr;       // analytics shard (this thread's alone:
                               // produced in-poll, drained post-poll
                               // by the SAME python thread)
#ifndef VTL_NO_URING
  bool to_pending = false;  // outstanding IORING_OP_TIMEOUT
  struct { int64_t sec, nsec; } to_ts {0, 0};  // __kernel_timespec
#endif
};

struct Lanes {
  std::atomic<uint64_t> gen{1};
  std::atomic<int> punt_all{0};         // armed failpoints force classic
  std::atomic<int> close_listeners{0};  // drain: stop accepting
  std::atomic<int> shutting{0};
  std::atomic<uint64_t> abort_at_us{0};
  std::atomic<int64_t> max_active{1ll << 30};
  std::atomic<uint64_t> wrr{0};  // shared cursor: even spread across lanes
  std::mutex mu;                 // guards the route + police swaps
  std::shared_ptr<LaneRoute> route;
  std::shared_ptr<PoliceTable> police;  // admission table (may be null)
  int engine = 0;  // 0 epoll, 1 uring
  int port = 0, bufsize = 65536;
  std::atomic<int> timeout_ms{900000};  // hot-settable (update timeout)
  int connect_timeout_ms = 3000;
  std::vector<Lane*> lanes;
  // adaptive overload (components/overload.py): when shed_rst is set,
  // over-limit accepts are RST-closed (SO_LINGER{1,0}) right here in C
  // instead of punting — a flash crowd must not buy a GIL crossing per
  // shed connection, and FIN closes would stack one TIME_WAIT each.
  std::atomic<int> shed_rst{0};
  std::atomic<uint64_t> accepted{0}, served{0}, active{0},
      punt_classic{0}, punt_stale{0}, punt_fail{0}, bytes{0},
      killed{0},  // idle-expired + shutdown-aborted (NOT served)
      shed{0};    // over-limit accepts RST-closed in C (shed_rst mode)
  // accept-latency EWMA (us): the accept->backend-connected span of
  // lane-owned sessions, alpha 1/8 — the C-plane analog of the python
  // accept EWMA the adaptive overload controller steers on (which was
  // otherwise blind to lane-served traffic). Relaxed read-modify-write
  // races between lanes lose one sample, never corrupt the value.
  std::atomic<uint64_t> lat_ewma_us{0};
  // per-stage latency accounting for EVERY lane connection (sampled or
  // not): the vproxy_accept_stage_us ABI widening — log2 buckets with
  // the SAME rule as utils/metrics.Histogram._bucket_of, drained by
  // Python as deltas and merged into the stage histograms so lane
  // connections stop being invisible to them. Stage index contract
  // with vtl.py LANE_STAGES: 0 backend_pick, 1 handover, 2 total.
  unsigned long long stage_count[3] = {};
  unsigned long long stage_sum_us[3] = {};
  unsigned long long stage_bkt[3][28] = {};
  // workload capture: lane-plane arrival process + per-connection
  // size/duration, same log2 bucket rule and the same delta-fold drain
  // as the stage histograms (lane 0's tick merges into the python
  // histograms). Index contract with vtl.py LANE_CAPTURES:
  // 0 interarrival_us, 1 conn_bytes, 2 conn_duration_ms. Gated on
  // g_wl_on so the capture-off A/B gate has a real knob to toggle.
  unsigned long long cap_count[3] = {};
  unsigned long long cap_sum[3] = {};
  unsigned long long cap_bkt[3][28] = {};
  std::atomic<uint64_t> cap_last_accept_us{0};
  // trace sampling cursor (1-in-N across this Lanes object's threads)
  std::atomic<uint64_t> trace_seq{0};
  // policing probe tallies, drained as deltas by lane 0's python
  // thread (the _fold_lane_sheds contract): checked counts entries
  // FOUND in the table; shed = RST-closed here; throttled = over-quota
  // punts (python's mirror re-decides against the overload ceiling, so
  // the fold deliberately skips this one — python counts it once);
  // monitored = over-quota admits; stale = consult-misses forced by a
  // generation mismatch (the fail-open gate).
  std::atomic<uint64_t> pol_checked{0}, pol_shed{0}, pol_throttled{0},
      pol_monitored{0}, pol_stale{0};
};

#define LANE_STAGE_PICK 0
#define LANE_STAGE_HANDOVER 1
#define LANE_STAGE_TOTAL 2

static inline int lanes_bucket(unsigned long long us) {
  // utils/metrics.Histogram._bucket_of, integer-us form: v<=1 -> 0,
  // else min(bit_length(v-1), 27) — 28 buckets incl. the +Inf tail
  if (us <= 1) return 0;
  int b = 64 - __builtin_clzll(us - 1);
  return b > 27 ? 27 : b;
}

static inline void lanes_stage_obs(Lanes* ow, int st,
                                   unsigned long long us) {
  __atomic_fetch_add(&ow->stage_count[st], 1ull, __ATOMIC_RELAXED);
  __atomic_fetch_add(&ow->stage_sum_us[st], us, __ATOMIC_RELAXED);
  __atomic_fetch_add(&ow->stage_bkt[st][lanes_bucket(us)], 1ull,
                     __ATOMIC_RELAXED);
}

// out = [count, sum_us, bucket0..bucket27] for one stage -> 30
int vtl_lanes_stage_stat(void* lp, int stage, uint64_t* out) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || stage < 0 || stage > 2) return -EINVAL;
  out[0] = __atomic_load_n(&ow->stage_count[stage], __ATOMIC_RELAXED);
  out[1] = __atomic_load_n(&ow->stage_sum_us[stage], __ATOMIC_RELAXED);
  for (int i = 0; i < 28; ++i)
    out[2 + i] = __atomic_load_n(&ow->stage_bkt[stage][i],
                                 __ATOMIC_RELAXED);
  return 30;
}

#define LANE_CAP_INTERARRIVAL 0
#define LANE_CAP_CONN_BYTES 1
#define LANE_CAP_CONN_MS 2

static inline void lanes_cap_obs(Lanes* ow, int w, unsigned long long v) {
  __atomic_fetch_add(&ow->cap_count[w], 1ull, __ATOMIC_RELAXED);
  __atomic_fetch_add(&ow->cap_sum[w], v, __ATOMIC_RELAXED);
  __atomic_fetch_add(&ow->cap_bkt[w][lanes_bucket(v)], 1ull,
                     __ATOMIC_RELAXED);
}

// out = [count, sum, bucket0..bucket27] for one capture series -> 30
int vtl_lanes_capture_stat(void* lp, int which, uint64_t* out) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || which < 0 || which > 2) return -EINVAL;
  out[0] = __atomic_load_n(&ow->cap_count[which], __ATOMIC_RELAXED);
  out[1] = __atomic_load_n(&ow->cap_sum[which], __ATOMIC_RELAXED);
  for (int i = 0; i < 28; ++i)
    out[2 + i] = __atomic_load_n(&ow->cap_bkt[which][i],
                                 __ATOMIC_RELAXED);
  return 30;
}

static inline void lane_trace(Lane* ln, uint64_t tid, uint8_t span,
                              uint64_t t0, uint64_t dur, uint64_t aux,
                              uint16_t err, uint8_t flags = 0) {
  if (!tid || !ln->tring) return;
  TraceRec r;
  r.trace_id = tid;
  r.t_start_ns = t0;
  r.dur_ns = dur;
  r.aux = aux;
  r.lane = (uint32_t)ln->idx;
  r.span = span;
  r.flags = flags;
  r.err = err;
  tr_push(ln->tring, r);
}

// drain one lane's span ring into `out` (TraceRec array, max slots);
// SPSC: at most one concurrent caller per (lanes, idx) by contract —
// components/lanes.py drains from that lane's own python thread
int vtl_trace_drain(void* lp, int idx, void* out, int max) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || idx < 0 || idx >= (int)ow->lanes.size() || max <= 0)
    return -EINVAL;
  TraceRing* r = ow->lanes[idx]->tring;
  if (!r) return 0;
  uint64_t h = r->head.load(std::memory_order_relaxed);
  uint64_t t = r->tail.load(std::memory_order_acquire);
  TraceRec* o = (TraceRec*)out;
  int n = 0;
  while (h != t && n < max) {
    o[n++] = r->buf[h & r->mask];
    ++h;
  }
  r->head.store(h, std::memory_order_release);
  return n;
}

// per-accept analytics: client address + picked backend into this
// lane's shard. Knob-off cost is the one relaxed load in the caller.
static void lane_hh_note(Lane* ln, const sockaddr_storage* ss, int cfd,
                         const LaneRoute* rt, int bidx) {
  if (!ln->hh) return;
  sockaddr_storage local;
  if (!ss) {  // uring multishot accept reports no peer address
    socklen_t sl = sizeof(local);
    if (getpeername(cfd, (sockaddr*)&local, &sl) == 0) ss = &local;
  }
  uint8_t ipb[16];
  int iplen = 0, cport = 0;
  if (ss && maglev_addr_bytes(ss, ipb, &iplen, &cport))
    hh_shard_update(ln->hh, HH_DIM_CLIENT, ipb, iplen, 1);
  if (rt && bidx >= 0 && bidx < (int)rt->bkeys.size())
    hh_shard_update(ln->hh, HH_DIM_BACKEND, rt->bkeys[bidx].data(),
                    (int)rt->bkeys[bidx].size(), 1);
}

// Drain one lane's shard into `out` (HHRec array). Same-thread
// contract as the shard updates: the lane's own python thread, after
// its vtl_lane_poll returned — there is no concurrent producer.
int vtl_hh_drain(void* lp, int idx, void* out, int max) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || idx < 0 || idx >= (int)ow->lanes.size() || !out || max <= 0)
    return -EINVAL;
  HHShard* sh = ow->lanes[idx]->hh;
  if (!sh) return 0;
  HHRec* o = (HHRec*)out;
  int n = 0;
  for (int i = 0; i < HH_SHARD_SLOTS && n < max; ++i) {
    HHSlot& s = sh->slots[i];
    if (!s.count) continue;
    o[n].count = s.count;
    o[n].lane = (uint32_t)idx;
    o[n].dim = s.dim;
    o[n].klen = s.klen;
    memset(o[n].key, 0, HH_KEY_MAX);
    memcpy(o[n].key, s.key, s.klen);
    ++n;
    s.count = 0;  // slot reclaimed; undrained slots keep their tallies
  }
  return n;
}

static inline void lanes_lat_obs(Lanes* ow, uint64_t us) {
  uint64_t old = ow->lat_ewma_us.load(std::memory_order_relaxed);
  ow->lat_ewma_us.store(old - old / 8 + us / 8,
                        std::memory_order_relaxed);
}

// process-global tallies (every LB's lanes), pump_counters idiom —
// /metrics surfaces them as vproxy_lane_*_total
static std::atomic<uint64_t> g_lane_accepted(0), g_lane_served(0),
    g_lane_punt_classic(0), g_lane_punt_stale(0), g_lane_punt_fail(0);

int vtl_lane_rec_size(void) { return (int)sizeof(LaneRec); }
int vtl_lane_punt_size(void) { return (int)sizeof(LanePunt); }
int vtl_maglev_rec_size(void) { return (int)sizeof(MaglevRec); }

static void addr_str(const sockaddr_storage* ss, char* ip, int iplen,
                     uint16_t* port) {
  ip[0] = 0;
  *port = 0;
  if (ss->ss_family == AF_INET) {
    auto* a = (const sockaddr_in*)ss;
    inet_ntop(AF_INET, &a->sin_addr, ip, iplen);
    *port = ntohs(a->sin_port);
  } else if (ss->ss_family == AF_INET6) {
    auto* a = (const sockaddr_in6*)ss;
    inet_ntop(AF_INET6, &a->sin6_addr, ip, iplen);
    *port = ntohs(a->sin6_port);
  }
}

static void lane_emit_punt(Lane* ln, int cfd, int kind, int err,
                           const sockaddr_storage* ss, const LaneRec* b,
                           uint64_t tid = 0) {
  LanePunt p;
  memset(&p, 0, sizeof(p));
  p.fd = cfd;
  p.kind = kind;
  p.err = err;
  p.trace_id = tid;
  sockaddr_storage local;
  if (!ss) {  // uring multishot accept reports no peer address
    socklen_t sl = sizeof(local);
    if (getpeername(cfd, (sockaddr*)&local, &sl) == 0) ss = &local;
  }
  if (ss) addr_str(ss, p.cip, sizeof(p.cip), &p.cport);
  if (b) {
    memcpy(p.bip, b->ip, sizeof(p.bip));
    p.bport = b->port;
  }
  ln->punt_q.push_back(p);
}

// a sampled accept leaving through a punt: close out the C-side spans
// (accept + the punt marker); the trace id rides the punt record so
// the python path CONTINUES the same trace (the cross-plane stitch)
static inline void lane_trace_punt(Lane* ln, uint64_t tid,
                                   uint64_t t_acc, int kind) {
  if (!tid) return;
  uint64_t now = mono_ns();
  lane_trace(ln, tid, TR_ACCEPT, t_acc, now - t_acc, 0, 0);
  lane_trace(ln, tid, TR_PUNT, now, 0, (uint64_t)kind, 0);
}

static void lane_client(Lane* ln, int cfd, const sockaddr_storage* ss) {
  Lanes* ow = ln->owner;
  uint64_t t_acc = mono_ns();  // stage histograms need it on every path
  ow->accepted.fetch_add(1, std::memory_order_relaxed);
  g_lane_accepted.fetch_add(1, std::memory_order_relaxed);
  if (g_wl_on.load(std::memory_order_relaxed)) {
    // lane-plane arrival process: one exchange on a shared cursor, the
    // delta is the inter-arrival gap across ALL lanes of this Lanes
    // object (the workload model wants the plane's merged process, not
    // per-thread ones). A relaxed-exchange race reorders two nearby
    // accepts — it perturbs one sample, never corrupts the histogram.
    uint64_t now_us = t_acc / 1000;
    uint64_t prev = ow->cap_last_accept_us.exchange(
        now_us, std::memory_order_relaxed);
    if (prev)
      lanes_cap_obs(ow, LANE_CAP_INTERARRIVAL,
                    now_us > prev ? now_us - prev : 0);
  }
  // deterministic 1-in-N sampling: one relaxed load when the knob is
  // off; a sampled accept allocates an even trace id (python: odd)
  uint64_t samp = g_trace_sample.load(std::memory_order_relaxed);
  uint64_t tid = 0;
  if (samp && ln->tring &&
      ow->trace_seq.fetch_add(1, std::memory_order_relaxed) % samp == 0)
    tid = g_trace_next.fetch_add(2, std::memory_order_relaxed);
  std::shared_ptr<LaneRoute> rt;
  std::shared_ptr<PoliceTable> pt;
  // the policing knob-off cost on this path is exactly this one
  // relaxed load (the g_hh_on contract)
  bool police = g_police_on.load(std::memory_order_relaxed) != 0;
  {
    std::lock_guard<std::mutex> g(ow->mu);
    rt = ow->route;
    if (police) pt = ow->police;
  }
  uint64_t cur = ow->gen.load(std::memory_order_relaxed);
  if ((int64_t)ow->active.load(std::memory_order_relaxed) >=
          ow->max_active.load(std::memory_order_relaxed) &&
      ow->shed_rst.load(std::memory_order_relaxed) &&
      !ow->close_listeners.load(std::memory_order_relaxed)) {
    // over the (adaptive) ceiling with RST-shed on: refuse HERE — no
    // punt, no Python, no TIME_WAIT. Python folds the counter into
    // vproxy_lb_shed_total{reason=adaptive} on the guard tick.
    struct linger lg = {1, 0};
    setsockopt(cfd, SOL_SOCKET, SO_LINGER, &lg, sizeof(lg));
    close(cfd);
    ow->shed.fetch_add(1, std::memory_order_relaxed);
    return;
  }
  if (ow->punt_all.load(std::memory_order_relaxed) ||
      ow->close_listeners.load(std::memory_order_relaxed) || !rt ||
      (rt->seq.empty() && rt->maglev.empty()) ||
      (int64_t)ow->active.load(std::memory_order_relaxed) >=
          ow->max_active.load(std::memory_order_relaxed)) {
    ow->punt_classic.fetch_add(1, std::memory_order_relaxed);
    g_lane_punt_classic.fetch_add(1, std::memory_order_relaxed);
    lane_trace_punt(ln, tid, t_acc, 0);
    lane_emit_punt(ln, cfd, LANE_PUNT_CLASSIC, 0, ss, nullptr, tid);
    return;
  }
  if (rt->gen != cur) {
    // the generation gate: a mutation since compile forces the classic
    // path; Python re-decides against current tables and re-installs
    ow->punt_stale.fetch_add(1, std::memory_order_relaxed);
    g_lane_punt_stale.fetch_add(1, std::memory_order_relaxed);
    lane_trace_punt(ln, tid, t_acc, 0);
    lane_emit_punt(ln, cfd, LANE_PUNT_CLASSIC, 0, ss, nullptr, tid);
    return;
  }
  // function-scope storage for a late-resolved peer address: `ss` may
  // be re-pointed at it inside the police/maglev branches and is read
  // after the branch ends (lane_hh_note, the connect-fail punt) — a
  // block-local would leave those reads dangling
  sockaddr_storage peer;
  if (police && pt) {
    // the POLICE_REC probe: ONE open-addressed lookup + bucket debit.
    // A generation mismatch is a forced consult-miss -> ADMIT: a stale
    // verdict must fail open (the opposite polarity of the route gate,
    // which fails closed to python) — refusing paying traffic on stale
    // evidence is the one thing a policer must never do.
    if (pt->gen != cur) {
      ow->pol_stale.fetch_add(1, std::memory_order_relaxed);
    } else {
      if (!ss) {  // uring multishot accept reports no peer address
        socklen_t sl = sizeof(peer);
        if (getpeername(cfd, (sockaddr*)&peer, &sl) == 0) ss = &peer;
      }
      uint8_t ipb[16];
      int iplen = 0, cport = 0;
      if (ss && maglev_addr_bytes(ss, ipb, &iplen, &cport)) {
        PoliceSlot* s = police_find(pt.get(), maglev_fnv64(ipb, iplen));
        if (s) {
          ow->pol_checked.fetch_add(1, std::memory_order_relaxed);
          if (!police_debit(*s, t_acc)) {  // over quota
            if (s->action == POLICE_ACT_SHED) {
              // refuse HERE: RST (no TIME_WAIT), no punt, no python —
              // an attacking herd must not buy a GIL crossing each
              if (tid)
                lane_trace(ln, tid, TR_POLICE, t_acc,
                           mono_ns() - t_acc, POLICE_ACT_SHED, 0);
              struct linger lg = {1, 0};
              setsockopt(cfd, SOL_SOCKET, SO_LINGER, &lg, sizeof(lg));
              close(cfd);
              ow->pol_shed.fetch_add(1, std::memory_order_relaxed);
              return;
            }
            if (s->action == POLICE_ACT_THROTTLE) {
              // throttle defers to the overload ceiling: punt so the
              // python mirror decides (shed iff at/over the ceiling)
              ow->pol_throttled.fetch_add(1, std::memory_order_relaxed);
              ow->punt_classic.fetch_add(1, std::memory_order_relaxed);
              g_lane_punt_classic.fetch_add(1, std::memory_order_relaxed);
              lane_trace_punt(ln, tid, t_acc, 0);
              lane_emit_punt(ln, cfd, LANE_PUNT_CLASSIC, 0, ss, nullptr,
                             tid);
              return;
            }
            // monitor: count the over-quota arrival, admit it
            ow->pol_monitored.fetch_add(1, std::memory_order_relaxed);
          }
        }
      }
    }
  }
  uint64_t t_pick0 = mono_ns();
  int bidx;
  if (!rt->maglev.empty()) {
    // consistent-hash pick: one FNV over the client addr (+port when
    // per-connection spread is configured) + one table load. The uring
    // multishot accept reports no peer address — resolve it here.
    if (!ss) {
      socklen_t sl = sizeof(peer);
      if (getpeername(cfd, (sockaddr*)&peer, &sl) == 0) ss = &peer;
    }
    uint8_t ipb[16];
    int iplen = 0, cport = 0;
    if (!ss || !maglev_addr_bytes(ss, ipb, &iplen, &cport)) {
      // no hashable address (AF_UNIX peer): the python path decides
      ow->punt_classic.fetch_add(1, std::memory_order_relaxed);
      g_lane_punt_classic.fetch_add(1, std::memory_order_relaxed);
      lane_trace_punt(ln, tid, t_acc, 0);
      lane_emit_punt(ln, cfd, LANE_PUNT_CLASSIC, 0, ss, nullptr, tid);
      return;
    }
    bidx = maglev_lookup(rt->maglev.data(), (int)rt->maglev.size(), ipb,
                         iplen, cport, rt->maglev_hash_port);
    if (bidx < 0 || bidx >= (int)rt->backends.size()) {
      // slot owned by a backend whose address failed to resolve at
      // install time: punt, never guess
      ow->punt_classic.fetch_add(1, std::memory_order_relaxed);
      g_lane_punt_classic.fetch_add(1, std::memory_order_relaxed);
      lane_trace_punt(ln, tid, t_acc, 0);
      lane_emit_punt(ln, cfd, LANE_PUNT_CLASSIC, 0, ss, nullptr, tid);
      return;
    }
  } else {
    bidx = rt->seq[ow->wrr.fetch_add(1, std::memory_order_relaxed) %
                   rt->seq.size()];
  }
  uint64_t t_pick1 = mono_ns();
  lanes_stage_obs(ow, LANE_STAGE_PICK, (t_pick1 - t_pick0) / 1000);
  if (g_hh_on.load(std::memory_order_relaxed))
    lane_hh_note(ln, ss, cfd, rt.get(), bidx);
  if (tid) {
    lane_trace(ln, tid, TR_ACCEPT, t_acc, t_pick0 - t_acc, 0, 0);
    lane_trace(ln, tid, TR_PICK, t_pick0, t_pick1 - t_pick0,
               (uint64_t)bidx, 0);
  }
  errno = 0;
  uint64_t pid = pump_connect_impl(ln->loop, cfd,
                                   (sockaddr*)&rt->addrs[bidx],
                                   rt->lens[bidx], ow->bufsize);
  if (!pid) {  // sync refusal: punt as connect failure (retry machinery)
    ow->punt_fail.fetch_add(1, std::memory_order_relaxed);
    g_lane_punt_fail.fetch_add(1, std::memory_order_relaxed);
    if (tid)
      lane_trace(ln, tid, TR_PUNT, mono_ns(), 0, 1,
                 (uint16_t)(errno ? errno : ECONNREFUSED));
    lane_emit_punt(ln, cfd, LANE_PUNT_CONNECT_FAIL,
                   errno ? errno : ECONNREFUSED, ss, &rt->backends[bidx],
                   tid);
    return;
  }
  ConnMeta& m = ln->meta[pid];
  m = ConnMeta{rt, bidx, 0, mono_us()};
  m.trace_id = tid;
  m.t_acc_ns = t_acc;
  {
    auto pit = ln->loop->pumps.find(pid);
    if (pit != ln->loop->pumps.end() && !pit->second->b_connecting) {
      // loopback connect resolved synchronously inside pump_connect
      Pump* p = pit->second;
      lanes_lat_obs(ow, p->connect_us);  // sync connect: ~0us
      uint64_t now = mono_ns();
      lanes_stage_obs(ow, LANE_STAGE_HANDOVER, p->connect_us);
      lanes_stage_obs(ow, LANE_STAGE_TOTAL, (now - t_acc) / 1000);
      if (tid) {
        lane_trace(ln, tid, TR_CONNECT, t_pick1, now - t_pick1, 0, 0);
        m.t_conn_ns = now;
      }
    }
  }
  ow->active.fetch_add(1, std::memory_order_relaxed);
}

static void lane_accept_batch(Lane* ln) {
  for (;;) {  // drain the backlog: one wake pays for the whole burst
    sockaddr_storage ss;
    socklen_t sl = sizeof(ss);
    int cfd = accept4(ln->lfd, (sockaddr*)&ss, &sl,
                      SOCK_NONBLOCK | SOCK_CLOEXEC);
    if (cfd < 0) break;  // EAGAIN (or EMFILE — retried on the next wake)
    lane_client(ln, cfd, &ss);
  }
}

#ifndef VTL_NO_URING
static void lane_arm_accept(Lane* ln) {
  Handler* h = ln->lh;
  vtl_uring_sqe* e = uring_sqe(ln->loop);
  if (!e) return;
  e->opcode = VTL_IORING_OP_ACCEPT;
  e->fd = h->fd;
  e->ioprio = VTL_IORING_ACCEPT_MULTISHOT;
  e->op_flags = SOCK_NONBLOCK | SOCK_CLOEXEC;
  e->user_data = (uint64_t)(uintptr_t)h | VTL_UTAG_ACCEPT;
  h->ms_accept = true;
  h->inflight++;
}
#endif

// reap DONE pumps: connect failures become punts (fd_a intact), clean
// completions count as served — Python never sees these pump ids
static void lane_reap(Lane* ln) {
  Loop* l = ln->loop;
  Lanes* ow = ln->owner;
  for (uint64_t id : l->done_pumps) {
    auto it = l->pumps.find(id);
    if (it == l->pumps.end()) continue;
    Pump* p = it->second;
    auto mit = ln->meta.find(id);
    uint64_t tid = mit != ln->meta.end() ? mit->second.trace_id : 0;
    if (p->connect_failed) {
      ow->punt_fail.fetch_add(1, std::memory_order_relaxed);
      g_lane_punt_fail.fetch_add(1, std::memory_order_relaxed);
      const LaneRec* b = (mit != ln->meta.end() && mit->second.route)
                             ? &mit->second.route->backends[mit->second.bidx]
                             : nullptr;
      if (tid)  // the trace rides the punt: python continues it
        lane_trace(ln, tid, TR_PUNT, mono_ns(), 0, 1, (uint16_t)p->err,
                   1);
      lane_emit_punt(ln, p->fd_a, LANE_PUNT_CONNECT_FAIL, p->err, nullptr,
                     b, tid);
    } else if (p->err == ECANCELED) {
      // lane-initiated kill (idle expiry / shutdown abort): a real
      // session, but NOT a served one — hit_rate must not count it
      ow->killed.fetch_add(1, std::memory_order_relaxed);
      ow->bytes.fetch_add(p->bytes_a2b + p->bytes_b2a,
                          std::memory_order_relaxed);
    } else {
      ow->served.fetch_add(1, std::memory_order_relaxed);
      g_lane_served.fetch_add(1, std::memory_order_relaxed);
      ow->bytes.fetch_add(p->bytes_a2b + p->bytes_b2a,
                          std::memory_order_relaxed);
    }
    if (!p->connect_failed && g_wl_on.load(std::memory_order_relaxed)) {
      // per-connection size/duration for the workload model: killed
      // sessions count too (they carried bytes), connect failures
      // never reached the serving distribution
      lanes_cap_obs(ow, LANE_CAP_CONN_BYTES, p->bytes_a2b + p->bytes_b2a);
      if (mit != ln->meta.end() && mit->second.t_acc_ns) {
        uint64_t now = mono_ns();
        uint64_t acc = mit->second.t_acc_ns;
        lanes_cap_obs(ow, LANE_CAP_CONN_MS,
                      now > acc ? (now - acc) / 1000000ull : 0);
      }
    }
    if (tid && !p->connect_failed) {
      // whole-lifetime close-out: the splice span covers connected ->
      // death (bytes in aux), the close span marks teardown + errno
      uint64_t now = mono_ns();
      ConnMeta& m = mit->second;
      uint64_t t0 = m.t_conn_ns ? m.t_conn_ns : m.t_acc_ns;
      lane_trace(ln, tid, TR_SPLICE, t0, now > t0 ? now - t0 : 0,
                 p->bytes_a2b + p->bytes_b2a, 0);
      lane_trace(ln, tid, TR_CLOSE, now, 0, 0, (uint16_t)p->err);
    }
    if (mit != ln->meta.end()) {
      ow->active.fetch_sub(1, std::memory_order_relaxed);
      ln->meta.erase(mit);
    }
    delete p;
    l->pumps.erase(it);
  }
  l->done_pumps.clear();
}

// connect deadline + idle timeout, the lane-local analog of the python
// sweep in TcpLB._arm_sweep (250ms cadence)
static void lane_sweep(Lane* ln, uint64_t now) {
  if (now < ln->next_sweep_us) return;
  ln->next_sweep_us = now + 250000;
  Lanes* ow = ln->owner;
  uint64_t cto = (uint64_t)ow->connect_timeout_ms * 1000;
  uint64_t idle =
      (uint64_t)ow->timeout_ms.load(std::memory_order_relaxed) * 1000;
  for (auto& kv : ln->meta) {
    auto pit = ln->loop->pumps.find(kv.first);
    if (pit == ln->loop->pumps.end()) continue;
    Pump* p = pit->second;
    if (p->dead) continue;
    if (p->b_connecting) {
      if (now - p->created_us >= cto)
        pump_fail_connect(ln->loop, p, ETIMEDOUT);
      continue;
    }
    uint64_t total = p->bytes_a2b + p->bytes_b2a;
    if (total != kv.second.last_total) {
      kv.second.last_total = total;
      kv.second.last_ts_us = now;
    } else if (now - kv.second.last_ts_us >= idle) {
      // ECANCELED marks lane-initiated kills (idle expiry here, the
      // shutdown grace abort) so reap counts them as killed, not served
      pump_kill(ln->loop, p, ECANCELED);
    }
  }
}

// free torn-down handlers — but never while the ring still owes them
// CQEs (uring user_data holds the raw pointer)
static void lane_gc(Loop* l) {
  size_t w = 0;
  for (size_t i = 0; i < l->garbage.size(); ++i) {
    Handler* h = l->garbage[i];
    if (h->inflight == 0)
      delete h;
    else
      l->garbage[w++] = h;
  }
  l->garbage.resize(w);
}

static void lane_event(Lane* ln, Handler* h, uint32_t e) {
  Loop* l = ln->loop;
  switch (h->kind) {
    case Handler::WAKE: {
      uint64_t v;
      while (read(l->wakefd, &v, 8) == 8) {}
      break;
    }
    case Handler::LANE:
      if (!ln->listener_closed) lane_accept_batch(ln);
      break;
    case Handler::PUMP_A:
    case Handler::PUMP_B: {
      Pump* p = h->pump;
      if (h->kind == Handler::PUMP_B && p->b_connecting) {
        // same contract as vtl_poll: SO_ERROR decides; EPOLLHUP with
        // SO_ERROR==0 is a successful connect whose peer already closed
        int err = 0;
        socklen_t elen = sizeof(err);
        getsockopt(h->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
        if (err) {
          pump_fail_connect(l, p, err);
        } else {
          p->b_connecting = false;
          p->connect_us = mono_us() - p->created_us;
          lanes_lat_obs(ln->owner, p->connect_us);
          {  // stage histograms + the sampled trace's connect span
            auto mit = ln->meta.find(p->id);
            if (mit != ln->meta.end()) {
              ConnMeta& m = mit->second;
              uint64_t now = mono_ns();
              lanes_stage_obs(ln->owner, LANE_STAGE_HANDOVER,
                              p->connect_us);
              lanes_stage_obs(ln->owner, LANE_STAGE_TOTAL,
                              (now - m.t_acc_ns) / 1000);
              if (m.trace_id) {
                uint64_t dur = p->connect_us * 1000ull;
                lane_trace(ln, m.trace_id, TR_CONNECT,
                           now > dur ? now - dur : now, dur, 0, 0);
                m.t_conn_ns = now;
              }
            }
          }
          Handler* ha =
              l->handlers.count(p->fd_a) ? l->handlers[p->fd_a] : nullptr;
          if (ha) ep_set(l, ha, VTL_EV_READ);
          ep_set(l, h, VTL_EV_READ);
          pump_run(l, p);
        }
        break;
      }
      if (e & EPOLLERR) {
        int err = 0;
        socklen_t elen = sizeof(err);
        getsockopt(h->fd, SOL_SOCKET, SO_ERROR, &err, &elen);
        pump_kill(l, p, err ? err : EIO);
      } else {
        pump_run(l, p);
      }
      break;
    }
    default:
      break;
  }
}

static void lane_wait_epoll(Lane* ln, int timeout_ms) {
  epoll_event eps[256];
  int n = epoll_wait(ln->loop->ep, eps, 256, timeout_ms);
  for (int i = 0; i < n; ++i) {
    Handler* h = (Handler*)eps[i].data.ptr;
    if (!ln->loop->valid.count(h)) continue;
    lane_event(ln, h, eps[i].events);
  }
}

#ifndef VTL_NO_URING
static void lane_cqe(Lane* ln, vtl_uring_cqe* c) {
  Loop* l = ln->loop;
  uint64_t ud = c->user_data;
  if ((ud & 7) == VTL_UTAG_TIMEOUT) {
    ln->to_pending = false;
    return;
  }
  Handler* h = (Handler*)(uintptr_t)(ud & ~7ull);
  int tag = (int)(ud & 7);
  bool valid = l->valid.count(h) != 0;
  if (tag == (int)VTL_UTAG_CANCEL) {
    h->inflight--;
    return;
  }
  if (tag == (int)VTL_UTAG_ACCEPT) {
    bool more = (c->flags & VTL_IORING_CQE_F_MORE) != 0;
    if (!more) {
      h->inflight--;
      h->ms_accept = false;
    }
    if (c->res >= 0) {
      if (valid && !ln->listener_closed)
        lane_client(ln, c->res, nullptr);
      else
        close(c->res);
    } else if (c->res == -EINVAL && valid && !ln->listener_closed) {
      // kernel without multishot accept: poll + accept4 batch instead
      ep_set(l, h, VTL_EV_READ);
      return;
    }
    if (!more && valid && !ln->listener_closed && !h->ms_accept &&
        c->res != -ECANCELED)
      lane_arm_accept(ln);
    return;
  }
  // oneshot poll completion
  h->inflight--;
  h->poll_pending = false;
  if (!valid) return;
  if (c->res > 0) lane_event(ln, h, (uint32_t)c->res);
  if (l->valid.count(h) && !h->poll_pending) {
    // re-arm per the CURRENT interest (dispatch may have changed it)
    uint16_t ev = 0;
    if (h->interest != (uint32_t)-1) {
      if (h->interest & VTL_EV_READ) ev |= POLLIN;
      if (h->interest & VTL_EV_WRITE) ev |= POLLOUT;
    }
    if (ev) uring_arm_poll(l, h, ev);
  }
}

static void lane_wait_uring(Lane* ln, int timeout_ms) {
  Loop* l = ln->loop;
  Uring* u = l->ur;
  if (!ln->to_pending) {
    // a TIMEOUT op bounds the enter (completes after 1 CQE or timeout);
    // ts lives on the Lane so the kernel's reference stays valid
    vtl_uring_sqe* e = uring_sqe(l);
    if (e) {
      ln->to_ts.sec = timeout_ms / 1000;
      ln->to_ts.nsec = (int64_t)(timeout_ms % 1000) * 1000000;
      e->opcode = VTL_IORING_OP_TIMEOUT;
      e->fd = -1;
      e->addr = (uint64_t)(uintptr_t)&ln->to_ts;
      e->len = 1;
      e->off = 1;
      e->user_data = VTL_UTAG_TIMEOUT;
      ln->to_pending = true;
    }
  }
  int r = sys_uring_enter(u->fd, u->to_submit, 1,
                          VTL_IORING_ENTER_GETEVENTS);
  if (r >= 0) u->to_submit = 0;
  unsigned head = *u->cq_head;
  unsigned tail = __atomic_load_n(u->cq_tail, __ATOMIC_ACQUIRE);
  while (head != tail) {
    lane_cqe(ln, &u->cqes[head & *u->cq_mask]);
    ++head;
  }
  __atomic_store_n(u->cq_head, head, __ATOMIC_RELEASE);
}
#endif  // !VTL_NO_URING

static void lane_abort_all(Lane* ln) {
  for (auto& kv : ln->loop->pumps)
    if (!kv.second->dead) pump_kill(ln->loop, kv.second, ECANCELED);
}

static Loop* lane_loop_new(bool uring) {
  Loop* l = new Loop();
  l->ep = epoll_create1(EPOLL_CLOEXEC);
  l->wakefd = eventfd(0, EFD_NONBLOCK | EFD_CLOEXEC);
  if (uring) l->ur = uring_new(256);  // nullptr -> epoll fallback
  Handler* h = new Handler{Handler::WAKE, 0, nullptr, l->wakefd,
                           (uint32_t)-1};
  l->handlers[l->wakefd] = h;
  l->valid.insert(h);
  ep_set(l, h, VTL_EV_READ);
  return l;
}

int vtl_lanes_free(void* lp);

// why the last vtl_lanes_new on THIS thread returned NULL: a real
// errno (bind/EMFILE) or EINVAL for bad args — Python surfaces it so
// a config error is not misreported as a port conflict
static thread_local int g_lanes_err = 0;
int vtl_lanes_errno(void) { return g_lanes_err; }

// -> Lanes handle or NULL (bind failure / bad args). engine_req: 0
// forces epoll, 1 uses io_uring when the runtime probe allows it.
// defer_accept_s > 0 arms TCP_DEFER_ACCEPT on every lane listener
// (client-speaks-first workloads: empty accepts never wake a lane).
void* vtl_lanes_new(const char* ip, int port, int backlog, int nlanes,
                    int bufsize, int engine_req, int timeout_ms,
                    int connect_timeout_ms, int defer_accept_s) {
  if (nlanes <= 0 || nlanes > 64) {
    g_lanes_err = EINVAL;
    return nullptr;
  }
  Lanes* ow = new Lanes();
  if (bufsize > 0) ow->bufsize = bufsize;
  if (timeout_ms > 0) ow->timeout_ms = timeout_ms;
  if (connect_timeout_ms > 0) ow->connect_timeout_ms = connect_timeout_ms;
  int probe = vtl_uring_probe();
  bool uring = engine_req && (probe & 1) && (probe & 2) && (probe & 8);
  int v6 = strchr(ip, ':') != nullptr;
  for (int i = 0; i < nlanes; ++i) {
    int lfd = vtl_tcp_listen(ip, port, backlog, 1, v6);
    if (lfd < 0) {
      g_lanes_err = -lfd;
      vtl_lanes_free(ow);
      return nullptr;
    }
    if (defer_accept_s > 0)
      setsockopt(lfd, IPPROTO_TCP, TCP_DEFER_ACCEPT, &defer_accept_s,
                 sizeof(defer_accept_s));
    if (port == 0) {  // first lane resolves the ephemeral port
      sockaddr_storage ss;
      socklen_t sl = sizeof(ss);
      if (getsockname(lfd, (sockaddr*)&ss, &sl) == 0)
        port = ss.ss_family == AF_INET6
                   ? ntohs(((sockaddr_in6*)&ss)->sin6_port)
                   : ntohs(((sockaddr_in*)&ss)->sin_port);
    }
    Lane* ln = new Lane();
    ln->owner = ow;
    ln->idx = i;
    ln->lfd = lfd;
    ln->loop = lane_loop_new(uring);
    ln->tring = new TraceRing(
        g_trace_ring_cap.load(std::memory_order_relaxed));
    ln->hh = new HHShard();
    if (i == 0 && uring && !ln->loop->ur) uring = false;  // setup refused
    Handler* h = new Handler{Handler::LANE, (uint64_t)i, nullptr, lfd,
                             (uint32_t)-1};
    ln->lh = h;
    ln->loop->handlers[lfd] = h;
    ln->loop->valid.insert(h);
#ifndef VTL_NO_URING
    if (ln->loop->ur)
      lane_arm_accept(ln);
    else
#endif
      ep_set(ln->loop, h, VTL_EV_READ);
    ow->lanes.push_back(ln);
  }
  // engine honesty: report uring ONLY when every lane actually got a
  // ring (a tight RLIMIT_MEMLOCK can fail ring N after ring 0 worked;
  // that lane runs epoll and the artifact must not claim otherwise)
  ow->engine = 1;
  for (Lane* ln : ow->lanes)
    if (!ln->loop->ur) ow->engine = 0;
  if (ow->lanes.empty()) ow->engine = 0;
  ow->port = port;
  return ow;
}

int vtl_lanes_port(void* lp) { return ((Lanes*)lp)->port; }

// one atomic load — the per-accept overload check's read (the 11-field
// stat is for list-detail/HTTP, not the hot path)
long long vtl_lanes_active(void* lp) {
  if (!lp) return 0;
  return (long long)((Lanes*)lp)->active.load(std::memory_order_relaxed);
}
int vtl_lanes_engine(void* lp) { return ((Lanes*)lp)->engine; }

uint64_t vtl_lane_gen(void* lp) {
  return ((Lanes*)lp)->gen.load(std::memory_order_relaxed);
}

// ONE atomic — safe from any thread; every upstream/ACL/backend-health
// mutation calls this (the lane-entry analog of vtl_switch_gen_bump)
void vtl_lane_gen_bump(void* lp) {
  ((Lanes*)lp)->gen.fetch_add(1, std::memory_order_relaxed);
}

// Install the compiled lane entry, stamped with the generation read
// BEFORE compilation began. -EAGAIN when a mutation raced the compile
// (Python recompiles against current state); otherwise the usable WRR
// sequence length (0 = punt-everything entry, e.g. non-trivial ACL).
int vtl_lane_install(void* lp, const void* recs, int n,
                     const int32_t* seq, int nseq, uint64_t gen) {
  Lanes* ow = (Lanes*)lp;
  if (gen != ow->gen.load(std::memory_order_relaxed)) return -EAGAIN;
  auto rt = std::make_shared<LaneRoute>();
  rt->gen = gen;
  const LaneRec* r = (const LaneRec*)recs;
  std::vector<int32_t> remap((size_t)(n > 0 ? n : 0), -1);
  for (int i = 0; i < n; ++i) {
    char ipb[48];
    memcpy(ipb, r[i].ip, 46);
    ipb[46] = 0;
    sockaddr_storage ss;
    socklen_t sl;
    if (mk_addr(ipb, r[i].port, r[i].v6, &ss, &sl) < 0) continue;
    remap[i] = (int32_t)rt->backends.size();
    rt->backends.push_back(r[i]);
    rt->addrs.push_back(ss);
    rt->lens.push_back(sl);
    char kb[64];
    int kl = snprintf(kb, sizeof(kb), "%s:%u", ipb,
                      (unsigned)r[i].port);
    rt->bkeys.emplace_back(kb, (size_t)(kl > 0 ? kl : 0));
  }
  for (int j = 0; j < nseq; ++j)
    if (seq[j] >= 0 && seq[j] < n && remap[seq[j]] >= 0)
      rt->seq.push_back(remap[seq[j]]);
  {
    std::lock_guard<std::mutex> g(ow->mu);
    ow->route = rt;
  }
  return (int)rt->seq.size();
}

// Install the compiled maglev route: n MaglevRec backends plus the
// slot->backend table (m entries, values indexing recs; -1 = unowned).
// Stamped + raced exactly like vtl_lane_install (-EAGAIN recompiles);
// returns the usable table size. hash_port=0 gives source affinity
// (client address only), 1 per-connection spread (address + port).
int vtl_lane_maglev_install(void* lp, const void* recs, int n,
                            const int32_t* table, int m, int hash_port,
                            uint64_t gen) {
  Lanes* ow = (Lanes*)lp;
  if (m < 0 || n < 0) return -EINVAL;
  if (gen != ow->gen.load(std::memory_order_relaxed)) return -EAGAIN;
  auto rt = std::make_shared<LaneRoute>();
  rt->gen = gen;
  rt->maglev_hash_port = hash_port ? 1 : 0;
  const MaglevRec* r = (const MaglevRec*)recs;
  std::vector<int32_t> remap((size_t)(n > 0 ? n : 0), -1);
  for (int i = 0; i < n; ++i) {
    char ipb[48];
    memcpy(ipb, r[i].ip, 46);
    ipb[46] = 0;
    sockaddr_storage ss;
    socklen_t sl;
    if (mk_addr(ipb, r[i].port, r[i].v6, &ss, &sl) < 0) continue;
    remap[i] = (int32_t)rt->backends.size();
    LaneRec lr;
    memcpy(lr.ip, r[i].ip, 46);
    lr.port = r[i].port;
    lr.v6 = r[i].v6;
    lr.weight = r[i].weight;
    rt->backends.push_back(lr);
    rt->addrs.push_back(ss);
    rt->lens.push_back(sl);
    char kb[64];
    int kl = snprintf(kb, sizeof(kb), "%s:%u", ipb,
                      (unsigned)r[i].port);
    rt->bkeys.emplace_back(kb, (size_t)(kl > 0 ? kl : 0));
  }
  rt->maglev.resize((size_t)m, -1);
  for (int j = 0; j < m; ++j)
    if (table[j] >= 0 && table[j] < n) rt->maglev[j] = remap[table[j]];
  if (rt->backends.empty()) rt->maglev.clear();  // punt-everything entry
  {
    std::lock_guard<std::mutex> g(ow->mu);
    ow->route = rt;
  }
  return (int)rt->maglev.size();
}

int vtl_police_rec_size(void) { return (int)sizeof(PoliceRec); }

void vtl_police_set_enabled(int on) {
  g_police_on.store(on ? 1 : 0, std::memory_order_relaxed);
}

// Install the compiled policing table, stamped with the generation read
// BEFORE the engine's compile began (the vtl_lane_install contract):
// -EAGAIN when a mutation raced it — python re-reads the generation and
// recompiles. Live bucket state carries over from the previous table
// for keys that persist across ticks (a reinstall must not hand every
// hot client a fresh burst). -> entries installed.
int vtl_police_install(void* lp, const void* recs, int n, uint64_t gen) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || n < 0 || (n > 0 && !recs)) return -EINVAL;
  if (gen != ow->gen.load(std::memory_order_relaxed)) return -EAGAIN;
  std::shared_ptr<PoliceTable> old;
  {
    std::lock_guard<std::mutex> g(ow->mu);
    old = ow->police;
  }
  auto pt = std::make_shared<PoliceTable>();
  pt->gen = gen;
  uint32_t cap = 8;
  while (cap < (uint32_t)(n * 2 + 1)) cap <<= 1;
  pt->slots = std::vector<PoliceSlot>(cap);
  const PoliceRec* r = (const PoliceRec*)recs;
  uint64_t now = mono_ns();
  int installed = 0;
  for (int i = 0; i < n; ++i) {
    if (!r[i].key_hash) continue;  // 0 is the empty-slot sentinel
    uint32_t idx = (uint32_t)r[i].key_hash & (cap - 1);
    for (uint32_t p = 0; p < cap; ++p, idx = (idx + 1) & (cap - 1)) {
      PoliceSlot& s = pt->slots[idx];
      if (s.key_hash && s.key_hash != r[i].key_hash) continue;
      bool fresh = !s.key_hash;
      s.key_hash = r[i].key_hash;
      s.rate_mtok = r[i].rate_mtok;
      s.burst_mtok = r[i].burst_mtok;
      s.action = r[i].action;
      s.level_mtok = (int64_t)r[i].burst_mtok;  // full (the engine law)
      s.t_ns = now;
      PoliceSlot* prev = police_find(old.get(), r[i].key_hash);
      if (prev && prev->rate_mtok == s.rate_mtok &&
          prev->burst_mtok == s.burst_mtok) {
        // same policy parameters: the bucket survives the reinstall
        // (read under the slot lock — lanes still debit the old table)
        while (prev->lk.exchange(1, std::memory_order_acquire)) {}
        s.level_mtok = prev->level_mtok;
        s.t_ns = prev->t_ns;
        prev->lk.store(0, std::memory_order_release);
      }
      if (fresh) ++installed;
      break;
    }
  }
  {
    std::lock_guard<std::mutex> g(ow->mu);
    ow->police = pt;
  }
  return installed;
}

// out: checked, shed, throttled, monitored, stale -> 5 (this Lanes
// object only; python drains as deltas on lane 0's tick)
int vtl_police_counters(void* lp, uint64_t* out) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || !out) return -EINVAL;
  out[0] = ow->pol_checked.load(std::memory_order_relaxed);
  out[1] = ow->pol_shed.load(std::memory_order_relaxed);
  out[2] = ow->pol_throttled.load(std::memory_order_relaxed);
  out[3] = ow->pol_monitored.load(std::memory_order_relaxed);
  out[4] = ow->pol_stale.load(std::memory_order_relaxed);
  return 5;
}

// Deterministic probe at an explicit timestamp — the C==python parity
// surface (tests drive this and engine.check_at with the same key/ns
// sequence and assert identical verdicts) and the TSan churn test's
// target. Runs the EXACT accept-path logic including the knob and the
// generation gate, and bumps the same counters: -2 knob off, -1 forced
// consult-miss (no table / stale stamp / unknown key -> admit),
// else 0 admit, or 1 + action code when over quota (1 monitor,
// 2 throttle, 3 shed).
int vtl_police_check(void* lp, const void* key, int klen,
                     uint64_t now_ns) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || !key || klen <= 0) return -EINVAL;
  if (!g_police_on.load(std::memory_order_relaxed)) return -2;
  std::shared_ptr<PoliceTable> pt;
  {
    std::lock_guard<std::mutex> g(ow->mu);
    pt = ow->police;
  }
  if (!pt) return -1;
  if (pt->gen != ow->gen.load(std::memory_order_relaxed)) {
    ow->pol_stale.fetch_add(1, std::memory_order_relaxed);
    return -1;
  }
  PoliceSlot* s = police_find(pt.get(),
                              maglev_fnv64((const uint8_t*)key,
                                           (size_t)klen));
  if (!s) return -1;
  ow->pol_checked.fetch_add(1, std::memory_order_relaxed);
  if (police_debit(*s, now_ns)) return 0;
  if (s->action == POLICE_ACT_SHED)
    ow->pol_shed.fetch_add(1, std::memory_order_relaxed);
  else if (s->action == POLICE_ACT_THROTTLE)
    ow->pol_throttled.fetch_add(1, std::memory_order_relaxed);
  else
    ow->pol_monitored.fetch_add(1, std::memory_order_relaxed);
  return 1 + (int)s->action;
}

int vtl_lanes_set_punt_all(void* lp, int on) {
  ((Lanes*)lp)->punt_all.store(on ? 1 : 0, std::memory_order_relaxed);
  return 0;
}

// hot-set the idle timeout (`update tcp-lb ... timeout` must govern
// lane-owned sessions too; the sweep reads it per pass)
int vtl_lanes_set_timeout(void* lp, int timeout_ms) {
  if (!lp || timeout_ms <= 0) return -EINVAL;
  ((Lanes*)lp)->timeout_ms.store(timeout_ms, std::memory_order_relaxed);
  return 0;
}

// n >= 0 is the REMAINING session budget (Python forwards
// max_sessions - its own active count, so the ceiling is shared across
// both admission paths); 0 = admit none (punt everything); n < 0
// restores the effectively-unlimited default.
int vtl_lanes_set_limit(void* lp, long long n) {
  ((Lanes*)lp)->max_active.store(n >= 0 ? n : (1ll << 30),
                                 std::memory_order_relaxed);
  return 0;
}

// adaptive-overload shed mode: on != 0 makes over-limit accepts
// RST-close in C (counted `shed`); off restores the classic punt so
// Python's shed path — with its drain/static accounting — decides.
int vtl_lanes_set_shed(void* lp, int on) {
  if (!lp) return -EINVAL;
  ((Lanes*)lp)->shed_rst.store(on ? 1 : 0, std::memory_order_relaxed);
  return 0;
}

// out: accepted, served, active, punt_classic, punt_stale, punt_fail,
// bytes, gen, engine, port, killed, shed, accept-latency EWMA us
// -> 13 (this Lanes object only)
int vtl_lanes_stat(void* lp, uint64_t* out) {
  Lanes* ow = (Lanes*)lp;
  if (!ow) return -EINVAL;
  out[0] = ow->accepted.load(std::memory_order_relaxed);
  out[1] = ow->served.load(std::memory_order_relaxed);
  out[2] = ow->active.load(std::memory_order_relaxed);
  out[3] = ow->punt_classic.load(std::memory_order_relaxed);
  out[4] = ow->punt_stale.load(std::memory_order_relaxed);
  out[5] = ow->punt_fail.load(std::memory_order_relaxed);
  out[6] = ow->bytes.load(std::memory_order_relaxed);
  out[7] = ow->gen.load(std::memory_order_relaxed);
  out[8] = (uint64_t)ow->engine;
  out[9] = (uint64_t)ow->port;
  out[10] = ow->killed.load(std::memory_order_relaxed);
  out[11] = ow->shed.load(std::memory_order_relaxed);
  out[12] = ow->lat_ewma_us.load(std::memory_order_relaxed);
  return 13;
}

// process-global: accepted, served, punt_classic, punt_stale, punt_fail
int vtl_lane_counters(uint64_t* out) {
  out[0] = g_lane_accepted.load(std::memory_order_relaxed);
  out[1] = g_lane_served.load(std::memory_order_relaxed);
  out[2] = g_lane_punt_classic.load(std::memory_order_relaxed);
  out[3] = g_lane_punt_stale.load(std::memory_order_relaxed);
  out[4] = g_lane_punt_fail.load(std::memory_order_relaxed);
  return 5;
}

static void lanes_wake(Lanes* ow) {
  for (Lane* ln : ow->lanes) {
    uint64_t one = 1;
    ssize_t r = write(ln->loop->wakefd, &one, 8);
    (void)r;
  }
}

// drain: each lane closes its OWN listener at the next poll tick (a
// cross-thread close would race fd reuse); live pumps run on
int vtl_lanes_close_listeners(void* lp) {
  Lanes* ow = (Lanes*)lp;
  ow->close_listeners.store(1, std::memory_order_relaxed);
  lanes_wake(ow);
  return 0;
}

// stop: listeners close, pumps get grace_ms to finish, then die; each
// lane thread's vtl_lane_poll returns -ESHUTDOWN once its loop is empty
int vtl_lanes_shutdown(void* lp, int grace_ms) {
  Lanes* ow = (Lanes*)lp;
  ow->close_listeners.store(1, std::memory_order_relaxed);
  ow->abort_at_us.store(mono_us() + (uint64_t)(grace_ms > 0 ? grace_ms : 0)
                                        * 1000,
                        std::memory_order_relaxed);
  ow->shutting.store(1, std::memory_order_relaxed);
  lanes_wake(ow);
  return 0;
}

// after every lane thread observed -ESHUTDOWN (python joins them first)
int vtl_lanes_free(void* lp) {
  Lanes* ow = (Lanes*)lp;
  for (Lane* ln : ow->lanes) {
    if (ln->lfd >= 0) close(ln->lfd);
    vtl_free(ln->loop);
    delete ln->tring;
    delete ln->hh;
    delete ln;
  }
  delete ow;
  return 0;
}

// The lane thread's park: runs the whole accept->route->splice lifetime
// in C for up to timeout_ms, returning early with punt records the
// moment any connection needs Python. -> punt count, 0 on timeout,
// -ESHUTDOWN when the lane drained after vtl_lanes_shutdown.
int vtl_lane_poll(void* lp, int idx, void* punts_out, int max_punts,
                  int timeout_ms) {
  Lanes* ow = (Lanes*)lp;
  if (!ow || idx < 0 || idx >= (int)ow->lanes.size() || max_punts <= 0)
    return -EINVAL;
  Lane* ln = ow->lanes[idx];
  Loop* l = ln->loop;
  uint64_t deadline =
      mono_us() + (uint64_t)(timeout_ms > 0 ? timeout_ms : 0) * 1000;
  LanePunt* out = (LanePunt*)punts_out;
  for (;;) {
    lane_gc(l);
    lane_reap(ln);
    if (!ln->punt_q.empty()) {
      int n = 0;
      while (n < max_punts && !ln->punt_q.empty()) {
        out[n++] = ln->punt_q.front();
        ln->punt_q.pop_front();
      }
      return n;
    }
    if (ow->close_listeners.load(std::memory_order_relaxed) &&
        !ln->listener_closed) {
      ln->listener_closed = true;
      auto it = l->handlers.find(ln->lfd);
      if (it != l->handlers.end()) {
        loop_detach(l, it->second);
        drop_handler(l, it->second);
        l->handlers.erase(it);
      }
      close(ln->lfd);
      ln->lfd = -1;
      ln->lh = nullptr;
    }
    if (ow->shutting.load(std::memory_order_relaxed)) {
      uint64_t ab = ow->abort_at_us.load(std::memory_order_relaxed);
      if (ab && mono_us() >= ab && !l->pumps.empty()) {
        lane_abort_all(ln);
        lane_reap(ln);
        if (!ln->punt_q.empty()) continue;  // deliver before exiting
      }
      if (l->pumps.empty()) return -ESHUTDOWN;
    }
    uint64_t now = mono_us();
    lane_sweep(ln, now);
    lane_reap(ln);
    if (!ln->punt_q.empty()) continue;
    if (now >= deadline) return 0;
    uint64_t until = std::min(deadline, ln->next_sweep_us);
    int wait_ms = until > now ? (int)((until - now) / 1000) : 0;
    if (wait_ms < 1) wait_ms = 1;
    if (wait_ms > 250) wait_ms = 250;
#ifndef VTL_NO_URING
    if (l->ur)
      lane_wait_uring(ln, wait_ms);
    else
#endif
      lane_wait_epoll(ln, wait_ms);
  }
}

}  // extern "C"
