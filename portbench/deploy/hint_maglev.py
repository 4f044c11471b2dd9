"""An Upstream's Host/SNI/URI hint rules and a Maglev table over its
backends: a HintMatcher and a MaglevMatcher on the default backend,
paired as a FusedPair for the fused accept path.

Entries:
* "cpick": ClassifyService.submit_classify_pick on the FusedPair -> the
  (rule index, backend index) pair (B1 on the card);
* "hint":  ClassifyService.submit_hint on the HintMatcher, what
  Upstream.next_async submits -> the rule index (B3 on the card).
"""
from __future__ import annotations

from portbench import gen
from portbench.deploy import Deployment, Entry


class HintMaglev(Deployment):
    def __init__(self, cfg: dict):
        from vproxy_tpu_torch.rules import engine as E
        from vproxy_tpu_torch.rules import maglev as M
        from vproxy_tpu_torch.rules.ir import Hint, HintRule
        from vproxy_tpu_torch.rules.service import ClassifyService
        from vproxy_tpu_torch.utils.torchenv import to_host
        self.cfg = cfg
        rules = gen.mk_rules(cfg["rules"], cfg["table_seed"])
        entries = gen.backends(cfg["backends"])
        self.plain = {"rules": rules, "backends": entries}
        self.hm = E.HintMatcher([HintRule(host=h, port=p, uri=u)
                                 for h, p, u in rules])
        self.mm = M.MaglevMatcher(entries, m=cfg["maglev_m"],
                                  device=self.hm.device)
        self.pair = M.FusedPair(self.hm, self.mm)
        svc = ClassifyService.get

        def cpick(payload, done, loop):
            svc().submit_classify_pick(
                self.pair, *payload, lambda v, p, _pl: done((v, p)), loop)

        def hint(payload, done, loop):
            svc().submit_hint(self.hm, payload, lambda i, _pl: done(i), loop)

        def mk_hint(q):
            return Hint(host=q[0], port=q[1], uri=q[2])

        def warm(m):
            return lambda ps, cap: to_host(
                m.dispatch_snap(m.snapshot(), ps, pad_to=cap))

        self.entries = {
            "cpick": Entry("cpick", cpick,
                           lambda q: (mk_hint(q[0]), q[1], q[2]),
                           self.pair, warm(self.pair)),
            "hint": Entry("hint", hint, mk_hint, self.hm, warm(self.hm)),
        }

    def pool(self, entry: str, traffic: dict) -> list:
        seed = traffic["pool_seed"]
        rules = self.plain["rules"]
        n = traffic["pool"]
        hints = gen.mk_queries(rules, n, seed + 1, traffic.get("zipf_s", 0))
        if entry == "hint":
            return hints
        ips = gen.mk_ips(n, seed + 2)
        ports = gen.flow_ports(n, seed + 3, traffic["port_none_every"])
        return list(zip(hints, ips, ports))

    def reference(self):
        from portbench.reference.hint import HintReference
        from portbench.reference.maglev import MaglevReference
        hr = HintReference(self.plain["rules"])
        mr = MaglevReference(self.plain["backends"], self.cfg["maglev_m"])

        def answer(entry, q, control=False):
            if entry == "hint":
                return hr.verdict(q, ties_last=control)
            # the control breaks the Maglev contract: source affinity
            # for every flow, the port dropped
            return (hr.verdict(q[0]), mr.pick(q[1], q[2],
                                              affinity_only=control))
        return answer

    def work(self, entry: str, q) -> tuple:
        """A hint: its host, uri and port (2 bytes) read and each byte
        taken into one op at least, a 4-byte verdict written. A pick adds
        its flow key (address, and port where given) read and taken in
        the same way, one 4-byte table entry read and a 4-byte pick
        written."""
        h = q if entry == "hint" else q[0]
        hb = len((h[0] or "").encode()) + len((h[2] or "").encode()) + 2
        nbytes, ops = hb + 4, hb
        if entry == "cpick":
            fb = len(q[1]) + (0 if q[2] is None else 2)
            nbytes += fb + 4 + 4
            ops += fb
        return nbytes, ops


def build(cfg: dict) -> HintMaglev:
    return HintMaglev(cfg)
