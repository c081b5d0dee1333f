"""Model families as files: each model of a configuration names its family,
``perfbench/families/<family>.py``, which holds every function that the
harness reaches a model's equations by (``util.FAMILY_API``).  A config
without a family, or a family file without one of those functions, fails
when it is loaded, naming the file."""
import json
import re

import pytest

from perfbench import util

CONFIGS = sorted((util.PKG / "configs").glob("*.json"))


def models(cfg):
    return cfg.get("stages", [cfg])


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_every_model_names_a_family_that_loads(path):
    for m in models(util.load_config(path)):
        fam = util.family(m)
        assert fam.__file__ == str(util.PKG / "families" /
                                   f"{m['family']}.py")
        assert all(callable(getattr(fam, f)) for f in util.FAMILY_API)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_a_config_without_a_family_fails_on_load(tmp_path, path):
    cfg = json.loads(path.read_text())
    del models(cfg)[-1]["family"]
    bad = tmp_path / path.name
    bad.write_text(json.dumps(cfg))
    with pytest.raises(ValueError, match=re.escape(str(bad))):
        util.load_config(bad)


@pytest.mark.parametrize("name", util.FAMILY_API)
def test_a_family_lacking_a_function_fails_on_load(tmp_path, name):
    src = (util.PKG / "families" / "qwen.py").read_text()
    assert src.count(f"\ndef {name}(") == 1
    bad = tmp_path / f"lacks_{name}.py"
    bad.write_text(src.replace(f"\ndef {name}(", f"\ndef _{name}("))
    with pytest.raises(ValueError, match=rf"lacks \['{name}'\]") as err:
        util.load_family(bad)
    assert str(bad) in str(err.value)


def test_an_unknown_family_fails_naming_its_file():
    with pytest.raises(ValueError, match="no model family file"):
        util.family({"family": "no-such-family"})
