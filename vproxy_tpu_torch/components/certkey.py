"""CertKey resource + SNI-dispatching context holder.

Parity: the reference cert-key resource (component/ssl/CertKey.java) and
ringbuffer/ssl/SSLContextHolder.java — choose(sni) scans each cert's
DNS names with exact then wildcard (`*.x`) matching (:50-66, :172
wildcard) with a quick sni->ctx cache (:27); the first cert-key is the
default when nothing matches. DNS names come from the certificate's SAN
list plus subject CN (parsed with `cryptography`).

The port's copy of vproxy_tpu/components/certkey.py, same names and behaviour.
"""
from __future__ import annotations

import ssl
from typing import Optional

from ..net.tls import install_sni_chooser


def _cert_dns_names(cert_path: str) -> list[str]:
    from cryptography import x509
    from cryptography.x509.oid import ExtensionOID, NameOID

    with open(cert_path, "rb") as f:
        cert = x509.load_pem_x509_certificate(f.read())
    names: list[str] = []
    try:
        san = cert.extensions.get_extension_for_oid(
            ExtensionOID.SUBJECT_ALTERNATIVE_NAME)
        names += san.value.get_values_for_type(x509.DNSName)
    except x509.ExtensionNotFound:
        pass
    for attr in cert.subject.get_attributes_for_oid(NameOID.COMMON_NAME):
        v = attr.value
        if isinstance(v, bytes):
            v = v.decode("latin-1")
        if v not in names:
            names.append(v)
    return names


class CertKey:
    def __init__(self, alias: str, cert_path: str, key_path: str):
        self.alias = alias
        self.cert_path = cert_path
        self.key_path = key_path
        self.dns_names = [n.lower() for n in _cert_dns_names(cert_path)]
        import threading
        self._native = None  # lazy native SSL_CTX handle (int) or False
        self._native_lock = threading.Lock()
        self.make_ctx()  # validate cert/key pair up front

    def native_ctx(self):
        """Native OpenSSL SSL_CTX handle for the C-side TLS splice pump
        (net/vtl.py tls_ctx_new), or None when native TLS is
        unavailable. Lazy and cached for the CertKey's lifetime —
        in-flight SSL sessions refcount the ctx, so the handle staying
        alive with the resource is the simple safe ownership."""
        with self._native_lock:
            if self._native is None:
                from ..net import vtl
                try:
                    if vtl.tls_available():
                        self._native = vtl.tls_ctx_new(self.cert_path,
                                                       self.key_path)
                    else:
                        self._native = False
                except OSError:
                    self._native = False
            return self._native or None

    def close_native(self) -> None:
        """Release the native SSL_CTX (cert-key removal / rotation).
        In-flight TLS sessions hold their own refs (OpenSSL refcounts
        the ctx via SSL_new), so freeing here never kills live splices;
        new handshakes on this CertKey become impossible — which is the
        point of removing it."""
        with self._native_lock:
            h, self._native = self._native, False
        if h:
            from ..net import vtl
            vtl.tls_ctx_free(h)

    def make_ctx(self) -> ssl.SSLContext:
        """Fresh server context; each holder (LB) builds its own so ALPN
        and SNI dispatch never leak between resources sharing a cert."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        ctx.load_cert_chain(self.cert_path, self.key_path)
        return ctx

    def matches(self, sni: str) -> bool:
        """Exact or wildcard DNS-name match (SSLContextHolder.java:50-66)."""
        sni = sni.lower()
        for name in self.dns_names:
            if name == sni:
                return True
            if name.startswith("*.") and "." in sni and \
                    sni.split(".", 1)[1] == name[2:]:
                return True
        return False


class CertKeyHolder:
    """VSSLContext analog: ordered cert-keys, SNI choose with cache."""

    def __init__(self, cert_keys: list[CertKey],
                 alpn: Optional[list[str]] = None):
        if not cert_keys:
            raise ValueError("at least one cert-key required")
        self.cert_keys = list(cert_keys)
        self._ctxs = [ck.make_ctx() for ck in self.cert_keys]
        self._quick: dict[str, ssl.SSLContext] = {}  # quickAccess cache
        if alpn:
            for ctx in self._ctxs:
                ctx.set_alpn_protocols(alpn)
        self.front_context = self._ctxs[0]
        install_sni_chooser(self.front_context, self.choose)

    def choose_cert_key(self, sni: Optional[str]) -> "CertKey":
        """The CertKey serving `sni` (exact -> wildcard -> default)."""
        if sni:
            for ck in self.cert_keys:
                if ck.matches(sni):
                    return ck
        return self.cert_keys[0]

    def choose(self, sni: Optional[str]) -> Optional[ssl.SSLContext]:
        if not sni:
            return None  # no SNI: default (first) cert
        hit = self._quick.get(sni)
        if hit is not None:
            return hit
        for ck, ctx in zip(self.cert_keys, self._ctxs):
            if ck.matches(sni):
                self._quick[sni] = ctx
                return ctx
        return None  # unmatched SNI falls back to the default cert
