"""A switch's route table and a SecurityGroup on one front: a CidrMatcher
over the routes, and a SecurityGroup of TCP rules with the default
stated in the configuration, both on the default backend.

Entries:
* "acl":   SecurityGroup.allow_async(TCP, addr, port), the gate every
  accepted connection takes -> allow (True) or deny (False);
* "route": ClassifyService.submit_cidr(routes, addr, None), a route
  lookup -> the first route's index, -1 for none.
Both are one launch of B4 a batch on the card.
"""
from __future__ import annotations

from portbench import gen
from portbench.deploy import Deployment, Entry


class CidrAclRoutes(Deployment):
    def __init__(self, cfg: dict):
        from vproxy_tpu_torch.components.secgroup import SecurityGroup
        from vproxy_tpu_torch.rules import engine as E
        from vproxy_tpu_torch.rules.ir import AclRule, Proto
        from vproxy_tpu_torch.rules.service import ClassifyService
        from vproxy_tpu_torch.utils.ip import Network
        from vproxy_tpu_torch.utils.torchenv import to_host
        self.cfg = cfg
        seed = cfg["table_seed"]
        routes = gen.route_nets(cfg["routes"], seed)
        acl = gen.acl_rules(cfg["acl_rules"], seed + 1)
        self.default_allow = cfg["acl_default"] == "allow"
        self.plain = {"routes": routes, "acl": acl}
        self.routes = E.CidrMatcher([Network(ip, m) for ip, m in routes])
        self.sg = SecurityGroup("portbench", default_allow=self.default_allow)
        self.sg.extend_rules([AclRule(a, Network(*net), Proto.TCP, lo, hi, ok)
                              for a, net, lo, hi, ok in acl])
        acl_m = self.sg._tables[Proto.TCP][0]
        svc = ClassifyService.get

        def allow(payload, done, loop):
            self.sg.allow_async(Proto.TCP, payload[0], payload[1], done, loop)

        def route(payload, done, loop):
            svc().submit_cidr(self.routes, payload, None,
                              lambda i, _pl: done(i), loop)

        def warm(m, gated):
            return lambda ps, cap: to_host(m.dispatch_snap(
                m.snapshot(), [p[0] if gated else p for p in ps],
                [p[1] for p in ps] if gated else None, pad_to=cap))

        self.entries = {
            "acl": Entry("acl", allow, tuple, acl_m, warm(acl_m, True)),
            "route": Entry("route", route, lambda q: q, self.routes,
                           warm(self.routes, False)),
        }

    def pool(self, entry: str, traffic: dict) -> list:
        seed = traffic["pool_seed"]
        fam = traffic["families"]
        args = (traffic["pool"], fam["v4"], fam["v6"], fam["mapped"],
                traffic["random_every"])
        if entry == "route":
            aimed = gen.family_queries(self.plain["routes"], args[0],
                                       seed + 2, *args[1:])
            return [a for a, _j in aimed]
        acl = self.plain["acl"]
        aimed = gen.family_queries([r[1] for r in acl], args[0], seed + 3,
                                   *args[1:])
        return [(a, p) for (a, _j), p in
                zip(aimed, gen.acl_ports(acl, aimed, seed + 3))]

    def reference(self):
        from portbench.reference.cidr import CidrReference
        rr = CidrReference(self.plain["routes"])
        acl = self.plain["acl"]
        ar = CidrReference([r[1] for r in acl], [(r[2], r[3]) for r in acl])
        default = self.default_allow

        def answer(entry, q, control=False):
            # the control breaks first match: the last match wins
            if entry == "route":
                return rr.first(q, last=control)
            i = ar.first(q[0], q[1], last=control)
            return acl[i][4] if i >= 0 else default
        return answer

    def work(self, entry: str, q) -> tuple:
        """The address (and the 2-byte port of an ACL query) read, each
        byte taken into one op at least, a 4-byte answer written."""
        a = q if entry == "route" else q[0]
        b = len(a) + (0 if entry == "route" else 2)
        return b + 4, b


def build(cfg: dict) -> CidrAclRoutes:
    return CidrAclRoutes(cfg)
