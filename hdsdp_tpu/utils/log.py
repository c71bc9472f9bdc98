"""Iteration logging (ref HDSDP_PrintHeader / HDSDP_PrintLog,
interface/hdsdp_algo.c:126-194)."""

from __future__ import annotations


class Logger:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def info(self, msg: str):
        if self.enabled:
            print(msg)

    def warning(self, msg: str):
        """Unexpected-but-recoverable events: printed even when the
        iteration log is silenced (a swallowed escalation failure must
        leave a trace, ADVICE r4)."""
        print(f"WARNING: {msg}")

    def header(self, method: str):
        if not self.enabled:
            return
        if method == "hsd":
            print("HDSDP starts. Using self-dual method \n")
            cols = ("nIter", "pObj", "dObj", "dInf", "Mu", "Step", "Tau", "T [H]")
        elif method == "infeas":
            print("HDSDP starts. Using infeasible dual method \n")
            cols = ("nIter", "pObj", "dObj", "dInf", "Mu", "Step", "|P|", "T [D]")
        else:
            print("HDSDP re-starts. Using feasible dual method \n")
            cols = ("nIter", "pObj", "dObj", "pInf", "Mu", "Step", "|P|", "T [P]")
        print(
            "    %5s  %15s  %15s  %8s  %8s  %5s  %6s   %5s "
            % cols
        )

    def iter_row(self, method, n, pobj, dobj, inf, mu, step, extra, t):
        if not self.enabled:
            return
        if method == "hsd":
            pobj = 1e30
        print(
            "    %5d  %+15.8e  %+15.8e  %8.2e  %8.2e  %5.2f  %5.1e  %4.1f "
            % (n, pobj, dobj, inf, mu, step, extra, t)
        )
