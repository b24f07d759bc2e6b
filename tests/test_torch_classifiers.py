"""The port's classifiers, losses, positional encoding and metrics against
the JAX package's, on the same numpy inputs and carried weights.

Tolerances: fp32 (``parity``) forwards 2e-5; the losses, the encoding and
the metrics 1e-6; ``fast`` (bf16) forwards 1.5 times the largest gap
measured on this CPU at these shapes (``FAST_ATOL``), both sides rounding
each product to bf16 in a different order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vit_deep_radiomics_tpu.core import precision as jprec
from vit_deep_radiomics_tpu.models import classifiers as jcls
from vit_deep_radiomics_tpu.models import convert as jconv
from vit_deep_radiomics_tpu.models import losses as jloss
from vit_deep_radiomics_tpu.ops import metrics as jmet
from vit_deep_radiomics_tpu.ops import posenc as jpos
from vit_deep_radiomics_tpu_torch.core import precision as tprec
from vit_deep_radiomics_tpu_torch.models import classifiers as tcls
from vit_deep_radiomics_tpu_torch.models import convert as tconv
from vit_deep_radiomics_tpu_torch.models import losses as tloss
from vit_deep_radiomics_tpu_torch.ops import metrics as tmet
from vit_deep_radiomics_tpu_torch.ops import posenc as tpos

D, FFN, NCLS = 32, 64, 2
PARITY_ATOL = 2e-5
EXACT_ATOL = 1e-6
# the largest gaps measured here (outputs of max |x| 2.4, 0.79, 0.11: one
# to two bf16 steps): unimodal 1.5625e-2, bimodal 4.88e-3, conv 8.54e-4
FAST_ATOL = {"unimodal": 2.4e-2, "bimodal": 7.5e-3, "conv": 1.3e-3}
POLICIES = {"parity": (jprec.PARITY, tprec.PARITY),
            "fast": (jprec.FAST, tprec.FAST)}


def _tokens(rng, b, s, padded):
    x = rng.normal(size=(b, s, D)).astype(np.float32)
    m = np.ones((b, s), bool)
    if padded:
        m[0, s // 2:] = False
        m[-1, 2:] = False
    return x, m


def _family(name, jpol, tpol, rng, padded):
    """(JAX model, port model, JAX inputs, port call kwargs)."""
    if name == "unimodal":
        args = dict(input_dim=D, ffn_dim=FFN, num_heads=4, num_classes=NCLS,
                    num_layers=2)
        x, m = _tokens(rng, 3, 9, padded)
        jin = ((x,), {"token_mask": m})
        return (jcls.TransformerNoduleClassifier(**args, policy=jpol),
                tcls.TransformerNoduleClassifier(**args, policy=tpol), jin)
    if name == "bimodal":
        args = dict(input_dim=D, ffn_dim_ct=FFN, ffn_dim_pet=48,
                    num_heads_ct=4, num_heads_pet=2, num_layers_ct=2,
                    num_layers_pet=1, num_classes=NCLS)
        ct, mct = _tokens(rng, 3, 11, padded)
        pet, mpet = _tokens(rng, 3, 6, padded)
        jin = ((ct, pet), {"ct_mask": mct, "pet_mask": mpet})
        return (jcls.TransformerNoduleBimodalClassifier(**args, policy=jpol),
                tcls.TransformerNoduleBimodalClassifier(**args, policy=tpol),
                jin)
    vol = rng.normal(size=(2, 4, 6, 5, D)).astype(np.float32)
    vm = np.ones(vol.shape[:4], bool)
    if padded:
        vm[1, 3:] = False
        vm[0, :, 4:] = False
    return (jcls.ConvNoduleClassifier(D, NCLS, policy=jpol),
            tcls.ConvNoduleClassifier(D, NCLS, policy=tpol),
            ((vol,), {"valid_mask": vm}))


def _torch_in(jin):
    args, kwargs = jin
    return ([torch.from_numpy(a) for a in args],
            {k: torch.from_numpy(v) for k, v in kwargs.items()})


def _carry(jmodel, tmodel, jin, seed=0):
    args, kwargs = jin
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(seed), *args,
                                        **kwargs))
    tmodel.load_state_dict(tconv.classifier_params_from_jax(params),
                           strict=True)
    return params


def _run_both(jmodel, tmodel, params, jin):
    args, kwargs = jin
    jout = jmodel.apply(params, *args, **kwargs)
    targs, tkw = _torch_in(jin)
    with torch.no_grad():
        tout = tmodel(*targs, **tkw)
    return jout, tout


def _max_gap(jout, tout):
    return max(float(np.abs(np.asarray(a, np.float32)
                            - b.float().numpy()).max())
               for a, b in zip(jout, tout))


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("policy", ["parity", "fast"])
@pytest.mark.parametrize("family", ["unimodal", "bimodal", "conv"])
def test_forward_matches_jax(family, policy, padded):
    """Carried weights, the same inputs: every output of the three
    families within 2e-5 under ``parity`` and the bf16 gap under ``fast``,
    with and without padded tokens (voxels for conv)."""
    jpol, tpol = POLICIES[policy]
    rng = np.random.default_rng(7)
    jmodel, tmodel, jin = _family(family, jpol, tpol, rng, padded)
    params = _carry(jmodel, tmodel, jin)
    jout, tout = _run_both(jmodel, tmodel, params, jin)
    assert len(jout) == len(tout)
    for a, b in zip(jout, tout):
        assert tuple(a.shape) == tuple(b.shape)
        assert b.dtype == torch.float32 and torch.isfinite(b).all()
    atol = PARITY_ATOL if policy == "parity" else FAST_ATOL[family]
    assert _max_gap(jout, tout) <= atol


@pytest.mark.parametrize("family", ["unimodal", "bimodal", "conv"])
def test_to_torch_state_dict_loads_strict(family):
    """JAX's ``classifier_params_to_torch`` (the reference's ``.pth``
    names) loads into the port with ``strict=True`` and gives JAX's
    logits; it equals the port's own bridge key for key."""
    rng = np.random.default_rng(3)
    jmodel, tmodel, jin = _family(family, jprec.PARITY, tprec.PARITY, rng,
                                  True)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), *jin[0],
                                        **jin[1]))
    ref = jconv.classifier_params_to_torch(params)
    ours = tconv.classifier_params_from_jax(params)
    assert sorted(ref) == sorted(ours)
    for k in ref:
        np.testing.assert_array_equal(ref[k], ours[k].numpy(), err_msg=k)
    tmodel.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in ref.items()}, strict=True)
    assert sorted(tmodel.state_dict()) == sorted(ref)
    jout, tout = _run_both(jmodel, tmodel, params, jin)
    assert _max_gap(jout, tout) <= PARITY_ATOL


@pytest.mark.parametrize("missing", ["pet", "ct"])
def test_bimodal_one_modality_is_encoded(missing):
    """With one modality absent the other is encoded and its head's logits
    fill all three outputs (JAX's fix of the reference's raw CLS)."""
    rng = np.random.default_rng(11)
    jmodel, tmodel, jin = _family("bimodal", jprec.PARITY, tprec.PARITY,
                                  rng, True)
    params = _carry(jmodel, tmodel, jin)
    (ct, pet), kw = jin
    keep = "ct" if missing == "pet" else "pet"
    jkw = {f"{keep}_tokens": ct if keep == "ct" else pet,
           f"{keep}_mask": kw[f"{keep}_mask"]}
    jout = jmodel.apply(params, **jkw)
    with torch.no_grad():
        tout = tmodel(**{k: torch.from_numpy(v) for k, v in jkw.items()})
    assert _max_gap(jout, tout) <= PARITY_ATOL
    torch.testing.assert_close(tout[0], tout[2], rtol=0, atol=0)
    torch.testing.assert_close(tout[0], tout[3], rtol=0, atol=0)
    with pytest.raises(ValueError, match="at least one"):
        tmodel()


def test_bimodal_rules():
    """The encoders' dropout defaults to 0.5 (unimodal 0.1, the conv head
    0.1), the heads take min(rate, 0.1), and both cross-attentions take
    ``num_heads_ct``."""
    bi = tcls.TransformerNoduleBimodalClassifier(
        D, FFN, FFN, num_heads_ct=4, num_heads_pet=2, num_layers_ct=1,
        num_layers_pet=1, num_classes=NCLS)
    assert bi.dropout_rate == 0.5
    assert bi.cross_attention_ct.multihead_attn.num_heads == 4
    assert bi.cross_attention_pet.multihead_attn.num_heads == 4
    assert bi.transformer_encoder_pet.layers[0].self_attn.num_heads == 2
    assert tcls.TransformerNoduleClassifier(
        D, FFN, 4, NCLS, 1).dropout_rate == 0.1
    assert tcls.ConvNoduleClassifier(D, NCLS).dropout_rate == 0.1
    # the heads' rate: with the encoders' dropout at 0.5, a head draws at
    # 0.1 — the fraction of zeros the bimodal classifier_ct head leaves
    gen = torch.Generator().manual_seed(0)
    drop = tcls._dropout(torch.ones(4000, 2 * D),
                         min(bi.dropout_rate, 0.1), gen)
    assert abs(float((drop == 0).float().mean()) - 0.1) < 0.01


def test_dropout_follows_the_generator():
    """Dropout is off without a generator; one seed gives one draw;
    ``dropout_rate = 0`` set on a built model turns it off."""
    rng = np.random.default_rng(5)
    _, tmodel, jin = _family("bimodal", jprec.PARITY, tprec.PARITY, rng,
                             True)
    tcls.init_classifier(tmodel, 0)
    args, kw = _torch_in(jin)
    with torch.no_grad():
        base = tmodel(*args, **kw)[0]
        a = tmodel(*args, **kw, generator=torch.Generator().manual_seed(1))
        b = tmodel(*args, **kw, generator=torch.Generator().manual_seed(1))
        torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
        assert not torch.allclose(a[0], base)
        tmodel.dropout_rate = 0.0
        c = tmodel(*args, **kw, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(c[0], base, rtol=0, atol=0)


def test_all_pad_sequence_stays_finite():
    """A sequence with no valid token still attends to its CLS: −1e30,
    not −inf, keeps every row finite; the JAX model agrees."""
    rng = np.random.default_rng(2)
    jmodel, tmodel, jin = _family("bimodal", jprec.PARITY, tprec.PARITY,
                                  rng, True)
    (ct, pet), kw = jin
    kw = dict(kw, pet_mask=np.zeros_like(kw["pet_mask"]))
    jin = ((ct, pet), kw)
    params = _carry(jmodel, tmodel, jin)
    jout, tout = _run_both(jmodel, tmodel, params, jin)
    assert all(torch.isfinite(t).all() for t in tout)
    assert _max_gap(jout, tout) <= PARITY_ATOL


def test_seq_mesh_raises():
    with pytest.raises(NotImplementedError, match="multi-device"):
        tcls.TransformerNoduleClassifier(D, FFN, 4, NCLS, 1, seq_mesh=object())
    cfg = {"models": {"transformer": {"feature_dim": D, "ct": {
        "num_layers": 1, "num_heads": 2, "mlp_ratio": 2}}}}
    with pytest.raises(NotImplementedError, match="multi-device"):
        tcls.build_classifier(cfg, "transformer", "ct", seq_mesh=object())


def test_build_classifier_families():
    cfg = {"models": {
        "transformer": {"feature_dim": D,
                        **{m: {"num_layers": 2, "num_heads": 4,
                               "mlp_ratio": 4} for m in ("ct", "pet")}},
        "conv": {"feature_dim": D, "ct": {"div": 2}, "pet": {"div": 2}}}}
    bi = tcls.build_classifier(cfg, "transformer", "petct")
    assert isinstance(bi, tcls.TransformerNoduleBimodalClassifier)
    assert bi.transformer_encoder_ct.layers[0].linear1.out_features == 4 * D
    assert isinstance(tcls.build_classifier(cfg, "transformer", "ct"),
                      tcls.TransformerNoduleClassifier)
    assert isinstance(tcls.build_classifier(cfg, "conv", "ct"),
                      tcls.ConvNoduleClassifier)


def test_init_classifier_is_seeded():
    a = tcls.init_classifier(tcls.ConvNoduleClassifier(D, NCLS), 3)
    b = tcls.init_classifier(tcls.ConvNoduleClassifier(D, NCLS), 3)
    for (k, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    assert float(a.conv1.bias.abs().max()) == 0.0
    assert float(a.conv1.weight.std()) > 0


def test_reference_state_dict_depth_checks():
    """The reference's names load as they are; the depth checks are
    JAX's."""
    rng = np.random.default_rng(0)
    jmodel, tmodel, jin = _family("unimodal", jprec.PARITY, tprec.PARITY,
                                  rng, False)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), *jin[0],
                                        **jin[1]))
    sd = jconv.classifier_params_to_torch(params)
    out = tconv.transformer_classifier_params_from_torch(sd)
    tmodel.load_state_dict(out, strict=True)
    tconv.transformer_classifier_params_from_torch(sd, num_layers=2)
    with pytest.raises(ValueError, match="num_layers=3"):
        tconv.transformer_classifier_params_from_torch(sd, num_layers=3)
    with pytest.raises(KeyError):
        tconv.transformer_classifier_params_from_torch(sd, bimodal=True)
    with pytest.raises(KeyError):
        tconv.conv_classifier_params_from_torch(sd)


# -- losses -------------------------------------------------------------------


def _logits_labels(rng, n=9):
    labels = np.eye(NCLS, dtype=np.float32)[rng.integers(0, NCLS, n)]
    logits = [rng.normal(size=(n, NCLS)).astype(np.float32) * 2
              for _ in range(3)]
    weight = rng.uniform(0, 1, n).astype(np.float32)
    weight[2] = 0.0
    return logits, labels, weight


@pytest.mark.parametrize("weighted", [False, True])
def test_focal_loss_matches_jax(weighted):
    rng = np.random.default_rng(1)
    (lg, _, _), labels, w = _logits_labels(rng)
    w = w if weighted else None
    ref = jloss.focal_loss(lg, labels, gamma=2.0, alpha=(0.25, 0.75),
                           example_weight=w)
    got = tloss.focal_loss(torch.from_numpy(lg), torch.from_numpy(labels),
                           gamma=2.0, alpha=(0.25, 0.75),
                           example_weight=None if w is None
                           else torch.from_numpy(w))
    assert abs(float(ref) - float(got)) <= EXACT_ATOL


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_modal_focal_loss_matches_jax(weighted):
    rng = np.random.default_rng(2)
    logits, labels, w = _logits_labels(rng)
    w = w if weighted else None
    ref = jloss.cross_modal_focal_loss(*logits, labels, alpha=(0.25, 0.75),
                                       example_weight=w)
    got = tloss.cross_modal_focal_loss(
        *(torch.from_numpy(x) for x in logits), torch.from_numpy(labels),
        alpha=(0.25, 0.75),
        example_weight=None if w is None else torch.from_numpy(w))
    assert abs(float(ref) - float(got)) <= EXACT_ATOL


# -- positional encoding and metrics -------------------------------------------


@pytest.mark.parametrize("d", [16, 32, 256])
def test_positional_encoding_matches_jax(d):
    """Coordinates in mm over a nodule crop's range (±40 mm)."""
    rng = np.random.default_rng(d)
    x, y, z = (rng.uniform(-40, 40, 300) for _ in range(3))
    ref = np.asarray(jpos.positional_encoding_3d(x, y, z, d))
    got = tpos.positional_encoding_3d(x, y, z, d).numpy()
    assert got.shape == ref.shape == (300, d)
    np.testing.assert_allclose(got, ref, rtol=0, atol=EXACT_ATOL)


def _metric_inputs(rng, n=40, ties=True, weighted=True):
    y = rng.integers(0, 2, n).astype(np.float32)
    s = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        s = np.round(s * 6) / 6          # tie groups
    w = rng.uniform(0.1, 2, n).astype(np.float32) if weighted else None
    if weighted:
        w[:3] = 0.0
    return y, s, w


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_metrics_match_jax(ties, weighted):
    rng = np.random.default_rng(int(ties) * 2 + int(weighted))
    y, s, w = _metric_inputs(rng, ties=ties, weighted=weighted)
    tw = None if w is None else torch.from_numpy(w)
    ref = float(jmet.roc_auc(y, s, w))
    got = float(tmet.roc_auc(torch.from_numpy(y), torch.from_numpy(s), tw))
    assert abs(ref - got) <= EXACT_ATOL
    yp = (s >= 0.5).astype(np.float32)
    for a, b in zip(jmet.binary_counts(y, yp, w),
                    tmet.binary_counts(torch.from_numpy(y),
                                       torch.from_numpy(yp), tw)):
        assert abs(float(a) - float(b)) <= EXACT_ATOL
    ref_m = jmet.binary_report_metrics(y, yp, w)
    got_m = tmet.binary_report_metrics(torch.from_numpy(y),
                                       torch.from_numpy(yp), tw)
    assert sorted(ref_m) == sorted(got_m)
    for k in ref_m:
        assert abs(float(ref_m[k]) - float(got_m[k])) <= EXACT_ATOL, k


def test_roc_auc_one_class_is_nan():
    y = torch.ones(5)
    assert torch.isnan(tmet.roc_auc(y, torch.rand(5)))
    assert jnp.isnan(jmet.roc_auc(np.ones(5), np.random.rand(5)))
