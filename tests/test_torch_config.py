"""The port's CfgNode (mirrors tests/config/test_cfgnode.py), plus its
parity with the JAX package's: the same YAML dump, and a JAX-made tree
merged into the port's. The port imports ``yaml`` only where YAML is read
or written."""

import io
import subprocess
import sys

import pytest

from gradslam_tpu.config import CfgNode as JCfgNode
from gradslam_tpu_torch.config import CfgNode


@pytest.fixture
def cfg():
    return CfgNode(
        {
            "SLAM": {"odom": "gradicp", "numiters": 20, "dsratio": 4},
            "DATA": {"height": 120, "width": 160, "seqlen": 10},
            "thresholds": [0.05, 0.1],
        }
    )


class TestAccess:
    def test_attribute_access(self, cfg):
        assert cfg.SLAM.odom == "gradicp"
        assert cfg.DATA.height == 120

    def test_dict_access(self, cfg):
        assert cfg["SLAM"]["numiters"] == 20

    def test_set_attribute(self, cfg):
        cfg.SLAM.numiters = 30
        assert cfg.SLAM.numiters == 30

    def test_missing_raises(self, cfg):
        with pytest.raises(AttributeError):
            _ = cfg.MISSING

    def test_invalid_type_raises(self, cfg):
        with pytest.raises(AttributeError):
            cfg.bad = object()


class TestFreeze:
    def test_freeze_blocks_writes(self, cfg):
        cfg.freeze()
        with pytest.raises(AttributeError):
            cfg.SLAM.numiters = 5
        assert cfg.is_frozen()

    def test_defrost(self, cfg):
        cfg.freeze()
        cfg.defrost()
        cfg.SLAM.numiters = 5
        assert cfg.SLAM.numiters == 5


class TestMerge:
    def test_merge_from_other(self, cfg):
        other = CfgNode({"SLAM": {"numiters": 10}})
        cfg.merge_from_other_cfg(other)
        assert cfg.SLAM.numiters == 10
        assert cfg.SLAM.odom == "gradicp"  # untouched keys kept

    def test_merge_nonexistent_raises(self, cfg):
        other = CfgNode({"SLAM": {"nope": 1}})
        with pytest.raises(KeyError):
            cfg.merge_from_other_cfg(other)

    def test_merge_new_allowed(self):
        cfg = CfgNode({"A": 1}, new_allowed=True)
        cfg.merge_from_other_cfg(CfgNode({"B": 2}))
        assert cfg.B == 2

    def test_merge_from_list(self, cfg):
        cfg.merge_from_list(["SLAM.numiters", "50", "DATA.height", 240])
        assert cfg.SLAM.numiters == 50
        assert cfg.DATA.height == 240

    def test_merge_from_list_odd_raises(self, cfg):
        with pytest.raises(ValueError):
            cfg.merge_from_list(["SLAM.numiters"])

    def test_type_coercion_list_tuple(self):
        cfg = CfgNode({"vals": (1, 2)})
        cfg.merge_from_other_cfg(CfgNode({"vals": (3, 4, 5)}))
        assert cfg.vals == (3, 4, 5)

    def test_type_mismatch_raises(self, cfg):
        with pytest.raises(ValueError):
            cfg.merge_from_list(["SLAM.odom", 42])

    def test_int_to_float_coercion(self):
        cfg = CfgNode({"x": 1.5})
        cfg.merge_from_list(["x", "2"])
        assert cfg.x == 2.0


class TestYaml:
    def test_dump_and_reload(self, cfg):
        text = cfg.dump()
        cfg2 = CfgNode.load_cfg(text)
        assert cfg2.SLAM.odom == "gradicp"
        assert cfg2.DATA.width == 160

    def test_load_from_file_obj(self, cfg):
        f = io.StringIO(cfg.dump())
        cfg2 = CfgNode.load_cfg(f)
        assert cfg2.SLAM.numiters == 20

    def test_merge_from_file(self, cfg, tmp_path):
        p = tmp_path / "override.yaml"
        p.write_text("SLAM:\n  numiters: 7\n")
        cfg.merge_from_file(str(p))
        assert cfg.SLAM.numiters == 7

    def test_load_python_module(self, tmp_path):
        p = tmp_path / "samplecfg.py"
        p.write_text(
            "from gradslam_tpu_torch.config import CfgNode\n"
            "cfg = CfgNode({'EXP': {'name': 'test'}})\n"
        )
        cfg = CfgNode.load_cfg_from_file(str(p))
        assert cfg.EXP.name == "test"


class TestDeprecatedRenamed:
    def test_deprecated_ignored(self, cfg):
        cfg.register_deprecated_key("OLD.key")
        cfg.merge_from_list(["OLD.key", 1])  # silently ignored
        assert "OLD" not in cfg

    def test_renamed_raises(self, cfg):
        cfg.register_renamed_key("OLD.numiters", "SLAM.numiters")
        with pytest.raises(KeyError):
            cfg.merge_from_list(["OLD.numiters", 1])

    def test_clone_independent(self, cfg):
        c2 = cfg.clone()
        c2.SLAM.numiters = 99
        assert cfg.SLAM.numiters == 20


class TestParityWithJax:
    def test_dump_equals_jax(self, cfg):
        jcfg = JCfgNode({"SLAM": {"odom": "gradicp", "numiters": 20, "dsratio": 4},
                         "DATA": {"height": 120, "width": 160, "seqlen": 10}, "thresholds": [0.05, 0.1]})
        assert cfg.dump() == jcfg.dump()
        assert str(cfg) == str(jcfg)

    def test_merge_a_jax_tree(self, cfg):
        cfg.merge_from_other_cfg(CfgNode(dict(JCfgNode({"SLAM": {"numiters": 3}}))))
        assert cfg.SLAM.numiters == 3

    def test_imports_without_yaml(self):
        code = (
            "import sys; sys.modules['yaml'] = None\n"
            "from gradslam_tpu_torch.config import CfgNode\n"
            "c = CfgNode({'A': {'b': 1}}); c.merge_from_list(['A.b', '2']); print(c.A.b)\n"
        )
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
        assert out.stdout.strip() == "2"
