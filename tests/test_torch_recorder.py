"""``.vec`` / ``.sca`` output: ``recorder.py`` and the CLI's
``--output-vectors`` / ``--output-scalars``, the port against the JAX
package.

Kademlia + KBRTest at 8 nodes built from one ini (the engine's two normal
draws set to 0 in both packages, test_torch_ini_run.py says why) runs to
3 simulated s through each package's CLI, sampling vectors every 0.5 s:

(a) the port's files (native writer, ``native/vecwriter.c`` built into
    ``build/native/``) are byte-equal to the JAX package's (its native
    writer);
(b) the port's pure-Python writer and the JAX package's give the same
    bytes as well (each CLI run again with its native library disabled);
(c) the files parse as OMNeT++ results: a ``version`` and ``run`` header,
    ``vector`` declarations with their rows (time, value) and ``scalar``
    lines, the run's alive count and simulated time among them.

The JAX side runs in one fresh interpreter (test_torch_engine.py says
why).
"""

import pathlib

import pytest
import torch

from oversim_tpu_torch import native
from oversim_tpu_torch.config import scenario as tsc
from test_torch_engine import JaxCall
from test_torch_ini_run import normals_off

torch.set_num_threads(1)

INI = ('**.overlayType = "oversim.overlay.kademlia.KademliaModules"\n'
       '**.tier1Type = "oversim.applications.kbrtestapp.KBRTestAppModules"\n'
       '**.tier1*.kbrTestApp.testMsgInterval = 0.5s\n'
       '**.targetOverlayTerminalNum = 8\n'
       '**.initPhaseCreationInterval = 0.1s\n')
ARGS = ["--until", "3", "--seed", "2", "--vector-interval", "0.5"]


def _outputs(d, tag):
    return ["--output-vectors", str(d / f"{tag}.vec"),
            "--output-scalars", str(d / f"{tag}.sca")]


# -- the JAX side (one fresh interpreter) -------------------------------------

def jax_side(ini, out_dir):
    import contextlib
    import io
    import numpy as np
    from oversim_tpu import __main__ as jmain
    from oversim_tpu import recorder as jrec
    from oversim_tpu.config import scenario as jsc
    d = pathlib.Path(out_dir)
    with normals_off(jsc, fresh_t_inf=True), \
            contextlib.redirect_stdout(io.StringIO()):
        assert jmain.main(["-f", ini, *ARGS, *_outputs(d, "jax_c"),
                           "--platform", "cpu"]) == 0
        jrec._lib, jrec._failed = None, True       # the Python writer
        assert jmain.main(["-f", ini, *ARGS, *_outputs(d, "jax_py"),
                           "--platform", "cpu"]) == 0
    return {"done": np.array(1)}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("rec")
    ini = d / "rec.ini"
    ini.write_text(INI)
    call = JaxCall("test_torch_recorder", "jax_side", ini=str(ini),
                   out_dir=str(d))
    from oversim_tpu_torch.__main__ import main
    with normals_off(tsc):
        assert main(["-f", str(ini), *ARGS, *_outputs(d, "port_c"),
                     "--device", "cpu", "--json"]) == 0
        saved = native._libs.pop("vecwriter", None)
        native._libs["vecwriter"] = None            # the Python writer
        try:
            assert main(["-f", str(ini), *ARGS, *_outputs(d, "port_py"),
                         "--device", "cpu", "--json"]) == 0
        finally:
            native._libs["vecwriter"] = saved
    call.result()
    return d


def test_files_byte_equal_across_packages(files, capsys):
    capsys.readouterr()
    assert native.library("vecwriter") is not None
    for ext in ("vec", "sca"):
        port = (files / f"port_c.{ext}").read_bytes()
        assert port == (files / f"jax_c.{ext}").read_bytes(), ext
        assert len(port) > 200


def test_python_writers_byte_equal(files):
    for ext in ("vec", "sca"):
        want = (files / f"port_c.{ext}").read_bytes()
        assert (files / f"port_py.{ext}").read_bytes() == want, ext
        assert (files / f"jax_py.{ext}").read_bytes() == want, ext


def test_files_parse_as_omnetpp_results(files):
    vec = (files / "port_c.vec").read_text().splitlines()
    assert vec[0] == "version 2" and vec[1].startswith("run General-")
    decl = {int(x.split()[1]): x.split()[3] for x in vec
            if x.startswith("vector ")}
    rows = [x.split("\t") for x in vec[2:] if not x.startswith("vector ")]
    assert {"aliveNodes", "kbr_delivered", "engine.pool_overflow"} <= \
        set(decl.values())
    by_vec = {}
    for vid, t, v in rows:
        by_vec.setdefault(int(vid), []).append((float(t), float(v)))
    alive = by_vec[next(k for k, n in decl.items() if n == "aliveNodes")]
    sca = (files / "port_c.sca").read_text().splitlines()
    scal = {x.split()[2]: float(x.split()[3]) for x in sca
            if x.startswith("scalar ")}
    # run_until advances whole 256-tick chunks: one sample passes 3 s
    # (times print with 9 significant digits in .vec, 12 in .sca)
    assert abs(alive[-1][0] - scal["simTime"]) < 1e-8 and alive[-1][1] == 8

    assert scal["aliveNodes"] == 8.0 and scal["simTime"] >= 3.0
    assert scal["kbr_delivered"] > 0
