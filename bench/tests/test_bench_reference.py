"""Each plain reference agrees with the port on the CPU at small sizes in
float32 compute (training: the loss and every gradient; serving: the
prefill's logits and each decode step's through the cache), and the
control, the reference in fp8, fails the cells' comparisons."""
import pytest
import torch

from bench import calibrate, compare, program, weights
from bench.drivers import train as tr
from bench.reference import common as ref
from bench.reference import family as family_of
from bench.tests.small import medium, small

FAMILIES = {"dense": "starcoder2-7b.train-4k"}


def _f32(name):
    spec, config, traffic = small(name)
    cfg = dict(config["model"], compute_dtype="float32", remat="none")
    return cfg, traffic


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reference_loss_and_gradients_match_the_port(family):
    cfg, traffic = _f32(FAMILIES[family])
    dev = torch.device("cpu")
    batch = tr.Feed(cfg, traffic, 3, dev)()
    model = program.build_model(cfg, dev)
    params = weights.make(cfg, 3, dev, requires_grad=True)
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    rparams = weights.make(cfg, 3, dev, requires_grad=True)
    rloss, rgrads = ref.loss_and_grads(cfg, rparams, batch,
                                       family_of(cfg).layer,
                                       ref.Precision("fp32"))
    assert float(loss.detach()) == pytest.approx(rloss, rel=1e-5)
    for (name, g) in zip(params, grads):
        err = float((g - rgrads[name]).norm())
        assert err <= 1e-4 * max(float(rgrads[name].norm()), 1e-6), name


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reference_logits_match_prefill_and_decode(family):
    cfg, _ = _f32(FAMILIES[family])
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(4)
    prompt = torch.randint(0, cfg["vocab_size"], (2, 64), generator=gen,
                           dtype=torch.int32)
    model = program.build_model(cfg, dev)
    params = weights.make(cfg, 4, dev)
    logits, cache = model.prefill(params, {"tokens": prompt}, max_len=70)
    got = [logits[:, 0, :cfg["vocab_size"]]]
    seq = prompt
    for _ in range(5):
        tok = got[-1].argmax(-1).to(torch.int32)[:, None]
        seq = torch.cat([seq, tok], 1)
        logits, cache = model.decode_step(params, tok, cache)
        got.append(logits[:, 0, :cfg["vocab_size"]])
    tree = ref.split_tree(params)
    rnd = ref.Precision("fp32")
    with torch.no_grad():
        h = ref.hidden(cfg, tree, seq, family_of(cfg).layer, rnd, remat=False)
        want = ref.logits_at(cfg, tree, h[:, 63:], rnd)
    for k, g in enumerate(got):
        scale = float(want[:, k].abs().max())
        assert float((g - want[:, k]).abs().max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_the_fp8_control_fails_the_training_comparison(family):
    """At small sizes and on three seeds, the reference computed in fp8
    in the program's place reads above at least one of the limits set at
    that size on every seed."""
    spec, config, traffic = small(FAMILIES[family])
    cfg, dev = config["model"], torch.device("cpu")
    for seed in (1, 2, 3):
        feed = tr.Feed(cfg, traffic, seed, dev)
        batches = [feed() for _ in range(traffic["checked_steps"])]
        ref32 = tr.reference_steps(cfg, traffic, seed, batches, dev)
        ref8 = tr.reference_steps(cfg, traffic, seed, batches, dev, "fp8")
        checks = compare.held(compare.train_readings(ref8, ref32),
                              traffic["limits"])
        assert not compare.all_within(checks), (seed, checks)


@pytest.mark.parametrize("cell", ["starcoder2-7b.serve-code"])
def test_the_fp8_control_fails_the_serving_comparison(cell):
    """Served by the port, the tokens lie within the limit of the float32
    reference's best; the tokens the fp8 reference puts first lie beyond
    it, on four seeds (the size at which the two separate on the CPU)."""
    spec, config, traffic = medium(cell)
    cfg, dev = config["model"], torch.device("cpu")
    for seed in (1, 2, 3, 4):
        line = calibrate.serve_line({"config": config, "traffic": traffic},
                                    seed, True, False, dev)
        limit = traffic["limits"]["gap"]
        assert line["program"]["gap"] <= limit < line["control"]["gap"], \
            (seed, line)
