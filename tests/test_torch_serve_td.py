"""The port's service demo (``repro_torch.examples.serve_td``) against the
JAX package's ``examples/serve_td.py`` on the CPU, act by act.

The reference runs in this process until its known failure at
``assert fits == ref_fits`` (:215: the resumed run disk-streams, the
uninterrupted one ran in memory, and the reference misses bitwise
equality across the two regimes); its globals and what it printed up to
there are compared with what the port printed.  The port's run exits 0:
it holds each resumed fit within ``RESUME_TOL`` instead
(``tests/test_torch_examples.py::DIFFERENCES``)."""
import contextlib
import io
import os
import re
import shutil

import pytest

pytest.importorskip("jax")

from repro_torch.examples import serve_td  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a fit the port printed (4 decimals) against the reference's own value
FIT_TOL = 1e-4
JOB = re.compile(r"^\s+(\S+)\s+job=(\d+) (\w+) backend=(\w+)\s+iters=(\d+) "
                 r"fit=([\d.]+) cache_hit=(\w+) h2d=([\d.]+)MB "
                 r"launches=(\d+)$", re.M)


@pytest.fixture(scope="module")
def runs():
    """The reference's globals and output (up to its failure, if any) and
    the port's exit code and output."""
    path = os.path.join(REPO, "examples", "serve_td.py")
    g = {"__name__": "__main__", "__file__": path}
    ref_out = io.StringIO()
    with contextlib.redirect_stdout(ref_out):
        try:
            exec(compile(open(path).read(), path, "exec"), g)
        except AssertionError:
            pass                # the known :215 failure, or an earlier one
    if "workdir" in g:          # act 3's directory, left by the failure
        shutil.rmtree(g["workdir"], ignore_errors=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_td.main(["--device", "cpu"])
    return g, ref_out.getvalue(), rc, out.getvalue()


def test_port_exits_zero_through_all_three_acts(runs):
    _, _, rc, out = runs
    assert rc == 0
    for line in ("multi-tenant factors == solo engine factors",
                 "async runtime: weighted shares + measured cancellation: OK",
                 "persistent store: kill -> restart -> resume: OK"):
        assert line in out


def test_act1_backends_cache_and_fits_match_reference(runs):
    """Each job's state, backend, sweeps, cache hit, H2D MB and fit; the
    service's hits and misses.  Streamed launches equal the reference's;
    the in-memory jobs' differ by the plain path's count, one dispatch per
    BLCO launch where the reference's scan (and K1/K2 on the card) make
    one per call."""
    g, ref_out, _, out = runs
    ref_jobs = {m[0]: m for m in JOB.findall(ref_out)}
    jobs = {m[0]: m for m in JOB.findall(out)}
    assert sorted(jobs) == sorted(ref_jobs) == sorted(g["jobs"])
    n_launches = len(g["b_uber"].launches)
    for name, (_, jid, state, backend, iters, fit, hit, h2d, launches) \
            in jobs.items():
        ref = ref_jobs[name]
        assert (jid, state, backend, iters, hit, h2d) == \
            (ref[1], ref[2], ref[3], ref[4], ref[6], ref[7]), name
        want_fit = g["svc"].status(g["jobs"][name]).fit
        assert abs(float(fit) - want_fit) <= FIT_TOL, name
        scale = n_launches if backend == "in_memory" else 1
        assert int(launches) == int(ref[8]) * scale, name
    pat = r"^service: (\d+) cache hit\(s\) / (\d+) build\(s\)"
    assert re.search(pat, out, re.M).groups() == \
        re.search(pat, ref_out, re.M).groups() == ("2", "2")
    assert serve_td.SOLO_TOL["cpu"] == (1e-5, 1e-6)    # the reference's
    assert "max |dfactor| 0.000e+00, rtol 1e-05, atol 1e-06" in out


def test_act2_shares_and_cancellation_match_reference(runs):
    g, ref_out, _, out = runs
    pat = r"^  tenant iterations: (\{.*\}) \(weights A=2, B=C=1\); " \
          r"cancellations=(\d+)$"
    got = re.search(pat, out, re.M).groups()
    assert got == re.search(pat, ref_out, re.M).groups()
    assert got == ("{'tenantA': 8, 'tenantB': 4, 'tenantC': 4}", "1")
    assert g["mt"]["jobs_cancelled"] == 1
    pat = r"cancelled tenantD mid-run: freed ([\d.]+)MB \(pooled " \
          r"([\d.]+)MB -> ([\d.]+)MB\)"
    assert re.search(pat, out).groups() == re.search(pat, ref_out).groups()


def test_act3_kill_restore_resume_match_reference(runs):
    """The kill iteration (thread timing decides it in both packages:
    each lies in [3, ITERS)), the restored backend, and the resume.  The
    reference's own resumed fits stay within ``FIT_TOL`` of its
    uninterrupted run, the comparison the port makes."""
    g, ref_out, _, out = runs
    pat = r"killed mid-run at iteration (\d+)/(\d+) \(snapshot: 1 job, " \
          r"1 tensor in store\)"
    kill, iters = map(int, re.search(pat, out).groups())
    ref_kill, ref_iters = map(int, re.search(pat, ref_out).groups())
    assert iters == ref_iters == serve_td.ITERS
    assert 3 <= kill < iters and 3 <= ref_kill < ref_iters
    pat = r"finished at iter (\d+) backend=(\w+)"
    assert re.search(pat, out).groups() == re.search(pat, ref_out).groups() \
        == (str(iters), "disk_streamed")
    assert len(g["fits"]) == len(g["ref_fits"]) == iters
    assert max(abs(a - b) for a, b in zip(g["fits"], g["ref_fits"])) \
        <= serve_td.RESUME_TOL["cpu"]
    m = re.search(r"max \|dfit\| (\S+) <= (\S+)\)", out)
    assert float(m.group(1)) <= float(m.group(2)) == \
        serve_td.RESUME_TOL["cpu"]
