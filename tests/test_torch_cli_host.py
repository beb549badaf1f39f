"""The port's host commands (``python -m grm_tpu_torch collect amr|genomes``,
``results site|serve``, ``settings show|get|set``) and ``main``'s
``--version``, ``--cite`` and ``--license`` against ``grm``'s
(``grm_tpu.cli.main``), in process: the same standard output, the same
exit codes, the same files byte for byte (the exported TSVs, the results
site, the settings file). Each CLI runs in a directory of its own with the
same relative paths and its own ``GRM_SETTINGS_PATH``, since paths land in
messages and settings. The FTP server is an in-process fake."""

import os
import re
import shutil
import subprocess
import sys

import pytest

from grm_tpu import cli as jcli
from grm_tpu_torch import cli as tcli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (the synthetic PATRIC table)
from test_torch_collect import _genome_files, fake_ftp  # noqa: E402,F401
from test_torch_results_site import _runs, _tree  # noqa: E402


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """One working directory per CLI, each with ``amr.txt`` (a synthetic
    PATRIC table) and its own relative ``GRM_SETTINGS_PATH``."""
    chip_smoke.write_amr_table(tmp_path / "amr.txt", 4000, 7)
    out = {}
    for name in ("grm", "port"):
        d = tmp_path / name
        d.mkdir()
        shutil.copy(tmp_path / "amr.txt", d / "amr.txt")
        out[name] = d
    monkeypatch.setenv("GRM_SETTINGS_PATH", os.path.join("conf",
                                                         "settings.json"))
    return out


def _run(main, argv, capsys, cwd, monkeypatch):
    monkeypatch.chdir(cwd)
    code = 0
    try:
        main(list(argv))
    except SystemExit as e:
        code = e.code
    captured = capsys.readouterr()
    return code, captured.out


def _both(argv, capsys, dirs, monkeypatch):
    """(exit code, stdout) of grm and of the port on ``argv``; asserts they
    agree and returns the port's."""
    a = _run(jcli.main, argv, capsys, dirs["grm"], monkeypatch)
    b = _run(tcli.main, argv, capsys, dirs["port"], monkeypatch)
    assert b == a
    return b


def _same_files(dirs, rel):
    a, b = _tree(dirs["grm"] / rel), _tree(dirs["port"] / rel)
    assert a == b
    return b


@pytest.mark.parametrize("argv", [["--version"], ["--cite"], ["--license"],
                                  ["settings", "show"],
                                  ["settings", "get", "amr_date"],
                                  ["settings", "get", "no_such_key"],
                                  ["settings", "set", "amr_date", "2026-10-17"],
                                  ["collect", "amr"],
                                  ["collect", "genomes", "--dest", "g"]])
def test_command_matches_grm(argv, capsys, dirs, monkeypatch):
    code, out = _both(argv, capsys, dirs, monkeypatch)
    assert code in (0, 1)
    if argv[0] == "--version":
        assert out.strip() == "grm-tpu 0.1.0"
    if argv[-1] == "no_such_key" or argv[0] == "collect":
        assert code == 1 and out.startswith("Error:")


def test_settings_round_trip(capsys, dirs, monkeypatch):
    for argv in (["settings", "set", "amr_database", "x/amr.txt"],
                 ["settings", "set", "custom", "v 1"],
                 ["settings", "get", "amr_database"],
                 ["settings", "get", "custom"],
                 ["settings", "show"]):
        code, out = _both(argv, capsys, dirs, monkeypatch)
        assert code == 0
    assert out.startswith("# conf/settings.json\n")
    _same_files(dirs, "conf")


@pytest.mark.parametrize("flags", [
    [], ["--list-datasets"],
    ["--species", "escherichia coli", "--antibiotic", "ampicillin",
     "--output-dir", "out"],
    ["--species", "klebsiella pneumoniae", "--drop-intermediate",
     "--filter-contradictions", "--numeric-phenotypes", "--output-dir", "out"],
    ["--antibiotic", "trimethoprim/sulfamethoxazole", "--numeric-phenotypes",
     "--output-dir", "out"],
])
def test_collect_amr_matches_grm(flags, capsys, dirs, monkeypatch):
    code, out = _both(["collect", "amr", "--amr-metadata", "amr.txt"] + flags,
                      capsys, dirs, monkeypatch)
    assert code == 0
    if "--list-datasets" in flags:
        assert len(out.splitlines()) > 1
    else:
        assert out.startswith("Total: ")
    if "--output-dir" in flags:
        assert len(_same_files(dirs, "out")) == 4
    # The setting the run persisted (an absolute path, one per directory)
    # serves a bare invocation.
    monkeypatch.chdir(dirs["port"])
    from grm_tpu_torch.settings import get_setting

    assert get_setting("amr_database") == str(dirs["port"] / "amr.txt")
    code, bare = _both(["collect", "amr"] + flags, capsys, dirs, monkeypatch)
    assert code == 0 and bare == out


@pytest.mark.parametrize("ids", [["--ids", "11.1", "22.2"],
                                 ["--ids", "11.1", "--ids-file", "ids.txt"],
                                 ["--ids", "11.1", "33.3", "22.2"]])
@pytest.mark.parametrize("features", [[], ["--features"]])
def test_collect_genomes_matches_grm(ids, features, capsys, dirs,
                                     monkeypatch, fake_ftp):
    _genome_files(fake_ftp)
    for d in dirs.values():
        (d / "ids.txt").write_text("22.2\n\n")
    code, out = _both(["collect", "genomes", "--dest", "g"] + ids + features,
                      capsys, dirs, monkeypatch)
    failed = "33.3" in ids
    assert code == (1 if failed else 0)
    assert ("Downloaded 2 genomes; %d errors." % failed) in out
    assert len(_same_files(dirs, "g")) == 2 * (2 if features else 1)


def test_results_site_and_serve_match_grm(capsys, dirs, monkeypatch,
                                          tmp_path):
    runs = _runs(tmp_path, "datasets")
    argv = ["results", "site", "--output-dir", "site"]
    for r in runs:
        argv += ["--run", r["species"], r["antibiotic"], r["results_dir"]]
    code, out = _both(argv, capsys, dirs, monkeypatch)
    assert code == 0
    assert out == "Wrote results site for 4 datasets to site\n"
    assert "index.html" in _same_files(dirs, "site")

    from socketserver import BaseServer

    def interrupted(self, poll_interval=0.5):
        raise KeyboardInterrupt  # ctrl-c, at once

    monkeypatch.setattr(BaseServer, "serve_forever", interrupted)
    serve = ["results", "serve", "--site-dir", "site", "--port", "0"]
    outs = [_run(main, serve, capsys, dirs[name], monkeypatch)
            for main, name in ((jcli.main, "grm"), (tcli.main, "port"))]
    norm = [(c, re.sub(r":\d+/", ":PORT/", o)) for c, o in outs]  # port 0
    assert norm[0] == norm[1]
    assert outs[1][1].startswith("Serving results site at http://127.0.0.1:")
    with pytest.raises(ValueError):
        tcli.main(["results", "serve", "--site-dir", "nope"])


def test_host_commands_never_touch_cuda(tmp_path):
    """In a fresh interpreter with CUDA hidden, the host commands run and
    import no kernel module."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               GRM_SETTINGS_PATH=str(tmp_path / "s.json"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    probe = ("import sys; from grm_tpu_torch.cli import main; "
             "main(['settings', 'set', 'amr_database', 'a.txt']); "
             "main(['settings', 'show']); main(['--cite']); "
             "bad = [m for m in sys.modules if m.startswith("
             "('grm_tpu_torch.ops', 'grm_tpu_torch.learning', 'jax'))]; "
             "assert not bad, bad")
    r = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert '"amr_database": "a.txt"' in r.stdout
