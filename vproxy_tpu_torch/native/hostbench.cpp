// hostbench — epoll HTTP/1.1 load tool for the host-path req/s bench.
//
// The port's copy of the reference's native load tool, line for line:
// only the text of `//` comments differs. tools/hostbench.py builds it
// into _build/ and drives it. The port's TcpLB data path is the native
// splice pump of native/vtl.cpp; measuring it through Python clients
// would measure the GIL instead. This file provides the two native
// endpoints of the harness (tools/hostbench.py owns orchestration):
//
//   hostbench server <port>
//       single-thread epoll HTTP server: reads until CRLFCRLF, writes a
//       fixed keep-alive response (RESP below, constant byte length).
//   hostbench client <ip> <port> <conns> <seconds> <pipeline>
//       opens <conns> keep-alive connections, keeps <pipeline> requests
//       in flight on each, counts completed responses by exact byte
//       framing. Prints one JSON line on stdout when done.
//
// Both sides keep a per-connection out-buffer and flush via EPOLLOUT.
// An EAGAIN/partial write must never drop bytes, or conns deadlock
// under the LB's splice backpressure. Self-contained, in the manner of
// wrk.
#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/epoll.h>
#include <sys/socket.h>
#include <time.h>
#include <unistd.h>

#include <string>

static const char RESP[] =
    "HTTP/1.1 200 OK\r\n"
    "Content-Length: 13\r\n"
    "Connection: keep-alive\r\n"
    "\r\n"
    "hello, world\n";
static const size_t RESP_LEN = sizeof(RESP) - 1;

static const char REQ[] =
    "GET / HTTP/1.1\r\n"
    "Host: bench.example.com\r\n"
    "Connection: keep-alive\r\n"
    "\r\n";
static const size_t REQ_LEN = sizeof(REQ) - 1;

static const int MAXFD = 65536;

static int set_nonblock(int fd) {
    int fl = fcntl(fd, F_GETFL, 0);
    return fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

static double now_s() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

struct Conn {
    std::string out;     // unsent bytes
    size_t inflight = 0; // client: requests awaiting a response
    size_t rxbytes = 0;  // client: bytes of current response received
    size_t reqpos = 0;   // server: progress through "\r\n\r\n"
    bool want_out = false;
};

static Conn conns[MAXFD];

// flush c.out; keeps EPOLLIN|EPOLLOUT registration in sync. Returns
// false if the connection died.
static bool flush_out(int ep, int fd, Conn &c) {
    while (!c.out.empty()) {
        ssize_t w = write(fd, c.out.data(), c.out.size());
        if (w > 0) {
            c.out.erase(0, (size_t)w);
            continue;
        }
        if (errno == EAGAIN || errno == EINTR) break;
        return false;
    }
    bool want = !c.out.empty();
    if (want != c.want_out) {
        c.want_out = want;
        epoll_event ev{};
        ev.events = EPOLLIN | (want ? EPOLLOUT : 0);
        ev.data.fd = fd;
        epoll_ctl(ep, EPOLL_CTL_MOD, fd, &ev);
    }
    return true;
}

static void drop(int ep, int fd) {
    epoll_ctl(ep, EPOLL_CTL_DEL, fd, nullptr);
    close(fd);
    conns[fd] = Conn{};
}

// --------------------------------------------------------------- server

static int run_server(int port) {
    signal(SIGPIPE, SIG_IGN);
    int lfd = socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
    sa.sin_port = htons((uint16_t)port);
    if (bind(lfd, (sockaddr *)&sa, sizeof(sa)) != 0 || listen(lfd, 1024) != 0) {
        perror("bind/listen");
        return 1;
    }
    set_nonblock(lfd);
    socklen_t slen = sizeof(sa);
    getsockname(lfd, (sockaddr *)&sa, &slen);
    printf("{\"listening\": %d}\n", ntohs(sa.sin_port));
    fflush(stdout);

    int ep = epoll_create1(0);
    epoll_event ev{}, evs[256];
    ev.events = EPOLLIN;
    ev.data.fd = lfd;
    epoll_ctl(ep, EPOLL_CTL_ADD, lfd, &ev);
    char buf[65536];

    for (;;) {
        int n = epoll_wait(ep, evs, 256, 1000);
        for (int i = 0; i < n; i++) {
            int fd = evs[i].data.fd;
            if (fd == lfd) {
                for (;;) {
                    int cfd = accept(lfd, nullptr, nullptr);
                    if (cfd < 0) break;
                    if (cfd >= MAXFD) { close(cfd); continue; }
                    set_nonblock(cfd);
                    setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
                    conns[cfd] = Conn{};
                    epoll_event ce{};
                    ce.events = EPOLLIN;
                    ce.data.fd = cfd;
                    epoll_ctl(ep, EPOLL_CTL_ADD, cfd, &ce);
                }
                continue;
            }
            Conn &c = conns[fd];
            if (evs[i].events & EPOLLOUT) {
                if (!flush_out(ep, fd, c)) { drop(ep, fd); continue; }
            }
            if (!(evs[i].events & (EPOLLIN | EPOLLERR | EPOLLHUP)))
                continue;
            ssize_t r = read(fd, buf, sizeof(buf));
            if (r == 0 || (r < 0 && errno != EAGAIN && errno != EINTR)) {
                drop(ep, fd);
                continue;
            }
            if (r < 0) continue;
            static const char T[] = "\r\n\r\n";
            for (ssize_t j = 0; j < r; j++) {
                if (buf[j] == T[c.reqpos]) {
                    if (++c.reqpos == 4) {
                        c.out.append(RESP, RESP_LEN);
                        c.reqpos = 0;
                    }
                } else {
                    c.reqpos = (buf[j] == '\r') ? 1 : 0;
                }
            }
            if (!flush_out(ep, fd, c)) drop(ep, fd);
        }
    }
    return 0;
}

// --------------------------------------------------------------- client

static int run_client(const char *ip, int port, int nconn, double secs,
                      int pipeline) {
    signal(SIGPIPE, SIG_IGN);
    int ep = epoll_create1(0);
    long long done = 0, errors = 0;
    int one = 1;
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, ip, &sa.sin_addr);

    for (int i = 0; i < nconn; i++) {
        int fd = socket(AF_INET, SOCK_STREAM, 0);
        if (fd < 0 || fd >= MAXFD) {  // same bound guard as the server
            if (fd >= 0) close(fd);
            errors++;
            continue;
        }
        if (connect(fd, (sockaddr *)&sa, sizeof(sa)) != 0) {
            fprintf(stderr, "connect: %s\n", strerror(errno));
            close(fd);
            errors++;
            continue;
        }
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        set_nonblock(fd);
        conns[fd] = Conn{};
        epoll_event ce{};
        ce.events = EPOLLIN;
        ce.data.fd = fd;
        epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ce);
        Conn &c = conns[fd];
        for (int p = 0; p < pipeline; p++) {
            c.out.append(REQ, REQ_LEN);
            c.inflight++;
        }
        if (!flush_out(ep, fd, c)) { drop(ep, fd); errors++; }
    }

    char buf[65536];
    epoll_event evs[256];
    double t0 = now_s(), tend = t0 + secs;
    while (now_s() < tend) {
        int n = epoll_wait(ep, evs, 256, 100);
        for (int i = 0; i < n; i++) {
            int fd = evs[i].data.fd;
            Conn &c = conns[fd];
            if (evs[i].events & EPOLLOUT) {
                if (!flush_out(ep, fd, c)) {
                    drop(ep, fd);
                    errors++;
                    continue;
                }
            }
            if (!(evs[i].events & (EPOLLIN | EPOLLERR | EPOLLHUP)))
                continue;
            ssize_t r = read(fd, buf, sizeof(buf));
            if (r == 0 || (r < 0 && errno != EAGAIN && errno != EINTR)) {
                drop(ep, fd);
                errors++;
                continue;
            }
            if (r < 0) continue;
            c.rxbytes += (size_t)r;
            while (c.rxbytes >= RESP_LEN && c.inflight > 0) {
                c.rxbytes -= RESP_LEN;
                c.inflight--;
                done++;
                c.out.append(REQ, REQ_LEN);
                c.inflight++;
            }
            if (!flush_out(ep, fd, c)) {
                drop(ep, fd);
                errors++;
            }
        }
    }
    double el = now_s() - t0;
    printf("{\"reqs\": %lld, \"secs\": %.3f, \"rps\": %.1f, "
           "\"errors\": %lld, \"conns\": %d, \"pipeline\": %d}\n",
           done, el, done / el, errors, nconn, pipeline);
    fflush(stdout);
    return 0;
}

// ----------------------------------------------------------- tls client
//
// TLS load mode for the TLS-terminating TcpLB bench: OpenSSL resolved
// with dlopen (no dev headers in this image; the ABI is stable), client
// handshakes run BEFORE the timed window, then the same pipelined
// request loop rides SSL_read/SSL_write nonblocking.

#include <dlfcn.h>

typedef struct ssl_ctx_st SSL_CTX_;
typedef struct ssl_st SSL_;
static struct {
    const void *(*TLS_client_method)(void);
    SSL_CTX_ *(*SSL_CTX_new)(const void *);
    long (*SSL_CTX_ctrl)(SSL_CTX_ *, int, long, void *);
    SSL_ *(*SSL_new)(SSL_CTX_ *);
    int (*SSL_set_fd)(SSL_ *, int);
    int (*SSL_connect)(SSL_ *);
    int (*SSL_read)(SSL_ *, void *, int);
    int (*SSL_write)(SSL_ *, const void *, int);
    int (*SSL_get_error)(const SSL_ *, int);
    long (*SSL_ctrl)(SSL_ *, int, long, void *);
} T;

static int tls_load() {
    void *h = dlopen("libssl.so.3", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libssl.so", RTLD_NOW | RTLD_GLOBAL);
    if (!h) return -1;
    dlopen("libcrypto.so.3", RTLD_NOW | RTLD_GLOBAL);
#define S(n)                                   \
    *(void **)(&T.n) = dlsym(h, #n);           \
    if (!T.n) return -1;
    S(TLS_client_method) S(SSL_CTX_new) S(SSL_CTX_ctrl) S(SSL_new)
    S(SSL_set_fd) S(SSL_connect) S(SSL_read) S(SSL_write) S(SSL_get_error)
    S(SSL_ctrl)
#undef S
    return 0;
}

static SSL_ *tlss[MAXFD];

static int run_tls_client(const char *ip, int port, const char *sni,
                          int nconn, double secs, int pipeline) {
    signal(SIGPIPE, SIG_IGN);
    if (tls_load() != 0) {
        fprintf(stderr, "libssl unavailable\n");
        return 3;
    }
    SSL_CTX_ *ctx = T.SSL_CTX_new(T.TLS_client_method());
    T.SSL_CTX_ctrl(ctx, 33 /*SSL_CTRL_MODE*/, 1L | 2L /*partial+moving*/,
                   nullptr);
    int ep = epoll_create1(0);
    long long done = 0, errors = 0;
    int one = 1;
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, ip, &sa.sin_addr);

    for (int i = 0; i < nconn; i++) {
        int fd = socket(AF_INET, SOCK_STREAM, 0);
        if (fd < 0 || fd >= MAXFD) {
            if (fd >= 0) close(fd);
            errors++;
            continue;
        }
        if (connect(fd, (sockaddr *)&sa, sizeof(sa)) != 0) {
            close(fd);
            errors++;
            continue;
        }
        setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        SSL_ *ssl = T.SSL_new(ctx);
        T.SSL_set_fd(ssl, fd);
        // SSL_set_tlsext_host_name = SSL_ctrl(ssl, 55, 0, name)
        T.SSL_ctrl(ssl, 55, 0, (void *)sni);
        if (T.SSL_connect(ssl) != 1) {  // blocking handshake (pre-window)
            close(fd);
            errors++;
            continue;
        }
        set_nonblock(fd);
        tlss[fd] = ssl;
        conns[fd] = Conn{};
        epoll_event ce{};
        ce.events = EPOLLIN;
        ce.data.fd = fd;
        epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ce);
        Conn &c = conns[fd];
        for (int p = 0; p < pipeline; p++) {
            c.out.append(REQ, REQ_LEN);
            c.inflight++;
        }
    }
    // helper: flush c.out through SSL_write; -1 fatal, 0 would-block-write
    auto tls_flush = [&](int fd, Conn &c) -> int {
        while (!c.out.empty()) {
            int w = T.SSL_write(tlss[fd], c.out.data(), (int)c.out.size());
            if (w > 0) {
                c.out.erase(0, (size_t)w);
            } else {
                int e = T.SSL_get_error(tlss[fd], w);
                if (e == 3) return 0;   // WANT_WRITE
                if (e == 2) return 1;   // WANT_READ: retry on next read ev
                return -1;
            }
        }
        return 1;
    };
    for (int fd = 0; fd < MAXFD; fd++)
        if (tlss[fd]) {
            int r = tls_flush(fd, conns[fd]);
            if (r < 0) { drop(ep, fd); tlss[fd] = nullptr; errors++; }
            else if (r == 0) {
                epoll_event ce{};
                ce.events = EPOLLIN | EPOLLOUT;
                ce.data.fd = fd;
                epoll_ctl(ep, EPOLL_CTL_MOD, fd, &ce);
            }
        }

    char buf[65536];
    epoll_event evs[256];
    double t0 = now_s(), tend = t0 + secs;
    while (now_s() < tend) {
        int n = epoll_wait(ep, evs, 256, 100);
        for (int i = 0; i < n; i++) {
            int fd = evs[i].data.fd;
            Conn &c = conns[fd];
            bool dead = false;
            for (;;) {
                int r = T.SSL_read(tlss[fd], buf, sizeof(buf));
                if (r > 0) {
                    c.rxbytes += (size_t)r;
                    continue;
                }
                int e = T.SSL_get_error(tlss[fd], r);
                if (e == 2 || e == 3) break;  // drained
                dead = true;
                break;
            }
            if (dead) {
                drop(ep, fd);
                tlss[fd] = nullptr;
                errors++;
                continue;
            }
            while (c.rxbytes >= RESP_LEN && c.inflight > 0) {
                c.rxbytes -= RESP_LEN;
                c.inflight--;
                done++;
                c.out.append(REQ, REQ_LEN);
                c.inflight++;
            }
            int fr = tls_flush(fd, c);
            if (fr < 0) {
                drop(ep, fd);
                tlss[fd] = nullptr;
                errors++;
            } else {
                epoll_event ce{};
                ce.events = fr == 0 ? (EPOLLIN | EPOLLOUT) : EPOLLIN;
                ce.data.fd = fd;
                epoll_ctl(ep, EPOLL_CTL_MOD, fd, &ce);
            }
        }
    }
    double el = now_s() - t0;
    printf("{\"reqs\": %lld, \"secs\": %.3f, \"rps\": %.1f, "
           "\"errors\": %lld, \"conns\": %d, \"pipeline\": %d}\n",
           done, el, done / el, errors, nconn, pipeline);
    fflush(stdout);
    return 0;
}

// ---------------------------------------------------------- short client
//
// Connection-per-request load (the reference's short-connection rows,
// benchmark/report/2019/06/05/bench.md:19): each slot loops
// connect -> one request -> full response -> close. Measures the
// accept path (ACL + classify + backend pick + pump setup/teardown).

static int run_short_client(const char *ip, int port, int nconn,
                            double secs) {
    signal(SIGPIPE, SIG_IGN);
    int ep = epoll_create1(0);
    long long done = 0, errors = 0;
    sockaddr_in sa{};
    sa.sin_family = AF_INET;
    sa.sin_port = htons((uint16_t)port);
    inet_pton(AF_INET, ip, &sa.sin_addr);
    // state per fd: 0 = connecting (EPOLLOUT pending), 1 = sent/reading
    static int st[MAXFD];

    auto open_one = [&]() -> bool {
        int fd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
        if (fd < 0 || fd >= MAXFD) {
            if (fd >= 0) close(fd);
            return false;
        }
        int r = connect(fd, (sockaddr *)&sa, sizeof(sa));
        if (r != 0 && errno != EINPROGRESS) {
            close(fd);
            return false;
        }
        conns[fd] = Conn{};
        st[fd] = 0;
        epoll_event ce{};
        ce.events = EPOLLOUT;
        ce.data.fd = fd;
        epoll_ctl(ep, EPOLL_CTL_ADD, fd, &ce);
        return true;
    };

    for (int i = 0; i < nconn; i++)
        if (!open_one()) errors++;

    char buf[65536];
    epoll_event evs[256];
    double t0 = now_s(), tend = t0 + secs;
    while (now_s() < tend) {
        int n = epoll_wait(ep, evs, 256, 100);
        for (int i = 0; i < n; i++) {
            int fd = evs[i].data.fd;
            Conn &c = conns[fd];
            if (evs[i].events & (EPOLLERR | EPOLLHUP)) {
                drop(ep, fd);
                errors++;
                open_one();
                continue;
            }
            if (st[fd] == 0 && (evs[i].events & EPOLLOUT)) {
                int err = 0;
                socklen_t el = sizeof(err);
                getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &el);
                if (err) {
                    drop(ep, fd);
                    errors++;
                    open_one();
                    continue;
                }
                st[fd] = 1;
                c.out.assign(REQ, REQ_LEN);
                if (!flush_out(ep, fd, c)) {
                    drop(ep, fd);
                    errors++;
                    open_one();
                    continue;
                }
                epoll_event ce{};
                ce.events = EPOLLIN | (c.out.empty() ? 0 : EPOLLOUT);
                ce.data.fd = fd;
                epoll_ctl(ep, EPOLL_CTL_MOD, fd, &ce);
                continue;
            }
            if (!(evs[i].events & EPOLLIN)) {
                if (!flush_out(ep, fd, c)) {
                    drop(ep, fd);
                    errors++;
                    open_one();
                }
                continue;
            }
            ssize_t r = read(fd, buf, sizeof(buf));
            if (r == 0 || (r < 0 && errno != EAGAIN && errno != EINTR)) {
                drop(ep, fd);
                errors++;
                open_one();
                continue;
            }
            if (r < 0) continue;
            c.rxbytes += (size_t)r;
            if (c.rxbytes >= RESP_LEN) {
                done++;
                drop(ep, fd);  // close; fresh connection next
                open_one();
            }
        }
    }
    double el = now_s() - t0;
    printf("{\"reqs\": %lld, \"secs\": %.3f, \"rps\": %.1f, "
           "\"errors\": %lld, \"conns\": %d, \"pipeline\": 0}\n",
           done, el, done / el, errors, nconn);
    fflush(stdout);
    return 0;
}

int main(int argc, char **argv) {
    if (argc >= 3 && strcmp(argv[1], "server") == 0)
        return run_server(atoi(argv[2]));
    if (argc >= 7 && strcmp(argv[1], "client") == 0)
        return run_client(argv[2], atoi(argv[3]), atoi(argv[4]),
                          atof(argv[5]), atoi(argv[6]));
    if (argc >= 6 && strcmp(argv[1], "shortclient") == 0)
        return run_short_client(argv[2], atoi(argv[3]), atoi(argv[4]),
                                atof(argv[5]));
    if (argc >= 8 && strcmp(argv[1], "tlsclient") == 0)
        return run_tls_client(argv[2], atoi(argv[3]), argv[4],
                              atoi(argv[5]), atof(argv[6]), atoi(argv[7]));
    fprintf(stderr,
            "usage: hostbench server <port>\n"
            "       hostbench client <ip> <port> <conns> <secs> <pipeline>\n"
            "       hostbench tlsclient <ip> <port> <sni> <conns> <secs> "
            "<pipeline>\n"
            "       hostbench shortclient <ip> <port> <conns> <secs>\n");
    return 2;
}
