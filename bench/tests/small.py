"""Small stand-ins for the cells, for the CPU tests: each cell's own
files with its widths and lengths cut to what a test run holds (the
family and the traffic's shape kept)."""
import copy
import json

from bench import harness

#: the benchmark's cells
CELLS = tuple(w["name"] for w in harness.load_spec()["workloads"])


def small_model(model: dict) -> dict:
    m = copy.deepcopy(model)
    m.update(num_layers=2, d_model=256, d_ff=512, vocab_size=500,
             num_heads=4, num_kv_heads=1)
    return m


#: the limits at these sizes, set as the cells' are from the readings of
#: the program (bf16) and of the fp8 control on six seeds on the CPU:
#: training's worst program readings 2.24e-4 (loss) and 4.48e-3
#: (gradient), the control's least 6.08e-4 and 7.06e-3; the change does
#: not separate them at this size and is held against half a batch
#: (0.21 or more); serving's, at ``medium``'s size, 0.028 against 0.087
SMALL_LIMITS = {"train": {"loss": 4e-4, "grad": 8e-3, "change": 0.05},
                "serve": {"gap": 0.05}}


def small_traffic(traffic: dict) -> dict:
    t = copy.deepcopy(traffic)
    if t["driver"] == "train":
        t.update(batch=2, seq_len=64)
    else:
        t.update(batch=2, batches_per_cycle=2, positions=80,
                 prompt={"median": 45, "sigma": 0.5, "multiple": 16},
                 output={"median": 3, "sigma": 0.5}, check_requests=3)
    t["limits"] = dict(SMALL_LIMITS[t["driver"]])
    return t


def small(name: str):
    """(spec, the configuration file of ``<config>.<traffic>`` with a small
    model, its small traffic), read from their files by name."""
    spec = harness.load_spec()
    root = harness.ROOT / "bench"
    config = json.loads((root / "configs" /
                         f"{name.rsplit('.', 1)[0]}.json").read_text())
    traffic = json.loads((root / "traffic" / f"{name}.json").read_text())
    config = dict(config, model=small_model(config["model"]))
    return spec, config, small_traffic(traffic)


def medium(name: str):
    """A serving cell at the smallest size found where the fp8 control
    separates from the program on the CPU: 4 layers of 512, prompts of 64
    and 128, 8 requests of about 8 tokens compared."""
    spec, config, traffic = small(name)
    config["model"].update(num_layers=4, d_model=512, d_ff=1024,
                           vocab_size=2000, num_heads=8, num_kv_heads=2)
    traffic.update(batch=4, positions=160,
                   prompt={"median": 90, "sigma": 0.5, "multiple": 64},
                   output={"median": 8, "sigma": 0.3}, check_requests=8)
    return spec, config, traffic
