"""Seeded simxlint violations for the port's linter: one per rule code,
plus suppressed and clean twins.

This file is a LINT FIXTURE, not production code:
``tests/test_torch_analysis.py`` runs ``repro_torch.analysis.simxlint``
over it, asserts each rule fires at the marked line and that every
``# simxlint: disable=`` twin and every ``# silent`` line stays silent.
It is never imported (no ``test_`` prefix) and is kept clean under ruff's
critical rules (E9, F63, F7, F82).
"""

import torch


# -- TH001: host reads inside step scope -------------------------------------


def make_branchy_step(cfg):
    def step(state):  # step scope: returned by a step factory
        if torch.any(state > 0):  # TH001 (if on a torch call)
            state = state + 1
        while state.sum() < 10:  # TH001 (while on a parameter's data)
            state = state * 2
        return state

    def host_helper(rows):  # NOT step scope: only called at build time
        if rows.any():  # silent (host code)
            return rows
        return rows

    host_helper(cfg)
    return step


def make_sync_step(cfg):
    def step(x, n: int):
        a = x.item()  # TH001 (.item)
        b = x.tolist()  # TH001 (.tolist)
        c = x.cpu()  # TH001 (.cpu)
        d = x.numpy()  # TH001 (.numpy)
        e = float(x)  # TH001 (float of a parameter)
        f = int(torch.sum(x))  # TH001 (int of a torch call)
        if n > 3:  # silent (a host int parameter)
            n = n - 1
        if x.dim() == 2 and x.shape[0] > 1:  # silent (metadata)
            n = n + 1
        if x is None:  # silent (identity)
            n = 0
        return a, b, c, d, e, f, n

    return step


def make_suppressed_step(cfg):
    def step(x):
        # a deliberate, documented host read: the disable twin is silent
        v = bool(torch.any(x))  # simxlint: disable=TH001
        return v

    return step


def marked_body(x):  # simxlint: jit-scope
    return x.item()  # TH001 (a marked def)


def helper_of_dispatch(x):
    return int(x)  # TH001 (called by name from dispatch)


# -- SC101: dispatch writing runtime-owned fields ----------------------------


def make_bad_rule_step(cfg):
    def dispatch(s, t, task_finish0, worker_finish0, free, comp, lost_w):
        helper_of_dispatch(t)
        updates = dict(  # SC101 (the runtime owns rnd)
            task_finish=task_finish0,
            rnd=s.rnd + 1,
        )
        updates["t"] = t + 1.0  # SC101 (the runtime owns t)
        return updates

    return dispatch


def make_good_rule_step(cfg):
    def dispatch(s, t, task_finish0, worker_finish0, free, comp, lost_w):
        return dict(task_finish=task_finish0, worker_finish=worker_finish0)  # silent

    return dispatch


# -- SC102: incomplete rule registration -------------------------------------


class Rule:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def register_rule(rule):
    return rule


def _init(cfg, tasks):
    return None


BAD_RULE = register_rule(Rule(name="bad", init=_init))  # SC102 (no build_step)
GOOD_RULE = register_rule(
    Rule(name="good", init=_init, build_step=make_good_rule_step)
)  # silent
