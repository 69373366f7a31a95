"""The port's training launcher, ``python -m repro_torch.launch.train``:
the ``--arch gtl_paper`` path prints the paper's study as the reference's
launcher does (``scenario=``, one ``F=`` line per summary row, the
overhead gains), from the port's own `run_scenario` at the same settings;
any other ``--arch`` (language-model training, not ported yet) exits
non-zero.  HAPT at 600 samples on the CPU, the plain route."""
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.experiment import run_scenario  # noqa: E402
from repro_torch.launch import train  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op torch thread while this module runs; restored after."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_gtl_paper_prints_the_study(capsys):
    train.main(["--arch", "gtl_paper", "--samples", "600", "--device",
                "cpu", "--kernel", "torch"])
    lines = capsys.readouterr().out.splitlines()
    want = run_scenario("hapt", n_samples=600, kernel="torch", device="cpu")
    assert lines[0] == "scenario=hapt"
    rows = want.summary_rows()
    assert lines[1:1 + len(rows)] == [f"  {name:14s} F={f:.3f}"
                                      for name, f in rows]
    assert re.fullmatch(r"  overhead: \{'gain_gtl': .*\}", lines[-1])
    assert len(lines) == len(rows) + 2


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "gtl"])
def test_other_archs_exit_nonzero(arch, capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", arch, "--device", "cpu"])
    assert exc.value.code != 0
    assert "language-model training" in capsys.readouterr().err
