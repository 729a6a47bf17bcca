"""Converters from the reference's on-disk formats.

A user switching from the PyTorch reference brings two kinds of artifacts:

  * trained checkpoints (``<iter>.pt``: {"config", "model": state_dict, ...},
    reference train.py:220-231), read by ``data/torch_reader.py`` (the
    standard library's zipfile and a restricted unpickler, no pickled code
    run) and converted by :func:`convert_reference_checkpoint` into a
    ``tsdiff_tpu.ckpt.v1`` payload, which ``tsdiff_tpu_torch.convert`` takes
    from there;
  * PyG dataset pickles and ``samples_all.pkl`` outputs (lists of
    torch_geometric Data), converted by :func:`convert_reference_dataset`;
    torch_geometric and rdkit are not needed (``data/pyg_compat.py``).

Name mapping for CondenseEncoderEpsNetwork (torch Linear weights are
(out, in) and transpose to flax kernels (in, out)):

  atom_embedding.weight                       -> atom_embedding/embedding
  atom_feat_embedding.weight                  -> atom_feat_embedding/Dense_0/kernel^T
  edge_encoder.bond_emb.weight                -> edge_enc/bond_emb/embedding
  edge_encoder.mlp.layers.{i}.*               -> edge_enc/mlp/layers_{i}/Dense_0/*
  edge_cat.{0,2}.*                            -> edge_cat/{lin0,lin1}/Dense_0/*
  encoder.interactions.{l}.conv.mlp.{0,2}.*   -> encoder/stack/{f1,f2}{w,b}[l]
  encoder.interactions.{l}.conv.lin1.weight   -> encoder/stack/l1w[l]
  encoder.interactions.{l}.conv.lin2.*        -> encoder/stack/l2{w,b}[l]
  encoder.interactions.{l}.lin.*              -> encoder/stack/o{w,b}[l]
  grad_dist_mlp.layers.{i}.*                  -> grad_dist_mlp/layers_{i}/Dense_0/*

and for DualEncoderEpsNetwork (``dualenc_params_from_state_dict``; the mlp
edge encoder only, as the JAX package converts it):

  edge_encoder_{global,local}.bond_emb.weight -> edge_encoder_*/bond_emb/embedding
  edge_encoder_*.mlp.layers.{i}.*             -> edge_encoder_*/mlp/layers_{i}/Dense_0/*
  edge_cat_{global,local}.{0,2}.*             -> edge_cat_*/{lin0,lin1}/Dense_0/* (TS)
  encoder_global.node_emb.weight              -> encoder_global/node_emb/embedding
  encoder_global.interactions.{l}.*           -> encoder_global/stack/* (as above)
  encoder_local.node_emb.weight               -> encoder_local/node_emb/embedding
  encoder_local.convs.{i}.nn.layers.{j}.*     -> encoder_local/convs_{i}/nn/layers_{j}/Dense_0/*
  grad_{global,local}_dist_mlp.layers.{i}.*   -> grad_*_dist_mlp/layers_{i}/Dense_0/*

GIN's ``convs.{i}.eps`` buffers are dropped (eps is fixed at 0).

Usage:
    python -m tsdiff_tpu_torch.data.convert ckpt <iter>.pt OUT.ckpt
    python -m tsdiff_tpu_torch.data.convert dataset PYG.pkl OUT.pkl
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np


def _t(w):
    return np.ascontiguousarray(np.asarray(w).T)


def _dense(sd: dict, prefix: str) -> dict:
    out = {"kernel": _t(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        out["bias"] = sd[f"{prefix}.bias"]
    return {"Dense_0": out}


def _schnet_stack(sd: dict, encoder: str, num_convs: int) -> dict:
    """The layer-stacked SchNet weights of ``<encoder>.interactions.*``."""

    def per_layer(name, transpose):
        return np.stack([_t(sd[name.format(l)]) if transpose else sd[name.format(l)]
                         for l in range(num_convs)])

    conv = encoder + ".interactions.{}.conv."
    return {
        "f1w": per_layer(conv + "mlp.0.weight", True),
        "f1b": per_layer(conv + "mlp.0.bias", False),
        "f2w": per_layer(conv + "mlp.2.weight", True),
        "f2b": per_layer(conv + "mlp.2.bias", False),
        "l1w": per_layer(conv + "lin1.weight", True),
        "l2w": per_layer(conv + "lin2.weight", True),
        "l2b": per_layer(conv + "lin2.bias", False),
        "ow": per_layer(encoder + ".interactions.{}.lin.weight", True),
        "ob": per_layer(encoder + ".interactions.{}.lin.bias", False),
    }


def condensenc_params_from_state_dict(state_dict: dict, num_convs: int) -> dict:
    """Reference CondenseEncoderEpsNetwork state_dict (numpy arrays) -> flax
    parameter tree ``{"params": {...}}`` of the condensed encoder."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}

    def dense(prefix):
        return _dense(sd, prefix)

    stack = _schnet_stack(sd, "encoder", num_convs)
    params = {
        "atom_embedding": {"embedding": sd["atom_embedding.weight"]},
        "atom_feat_embedding": {"Dense_0": {"kernel": _t(sd["atom_feat_embedding.weight"])}},
        "edge_enc": {
            "bond_emb": {"embedding": sd["edge_encoder.bond_emb.weight"]},
            "mlp": {f"layers_{i}": dense(f"edge_encoder.mlp.layers.{i}") for i in range(2)},
        },
        "edge_cat": {"lin0": dense("edge_cat.0"), "lin1": dense("edge_cat.2")},
        "encoder": {"stack": stack},
        "grad_dist_mlp": {f"layers_{i}": dense(f"grad_dist_mlp.layers.{i}") for i in range(3)},
    }
    return {"params": params}


def dualenc_params_from_state_dict(state_dict: dict, config: dict) -> dict:
    """Reference DualEncoderEpsNetwork state_dict (numpy arrays) -> flax
    parameter tree ``{"params": {...}}`` of the dual encoder (the mlp edge
    encoder only; the gaussian one raises)."""
    sd = {k: np.asarray(v) for k, v in state_dict.items()}
    model = config["model"]
    if model.get("edge_encoder", "mlp") != "mlp":
        raise NotImplementedError(
            "dualenc conversion supports the mlp edge encoder only, as the JAX package's")

    def dense(prefix):
        return _dense(sd, prefix)

    def edge_encoder(side):
        return {
            "bond_emb": {"embedding": sd[f"edge_encoder_{side}.bond_emb.weight"]},
            "mlp": {f"layers_{i}": dense(f"edge_encoder_{side}.mlp.layers.{i}")
                    for i in range(2)},
        }

    def mlp3(prefix):
        return {f"layers_{i}": dense(f"{prefix}.layers.{i}") for i in range(3)}

    params = {
        "edge_encoder_global": edge_encoder("global"),
        "edge_encoder_local": edge_encoder("local"),
        "encoder_global": {
            "node_emb": {"embedding": sd["encoder_global.node_emb.weight"]},
            "stack": _schnet_stack(sd, "encoder_global", model["num_convs"]),
        },
        "encoder_local": {
            "node_emb": {"embedding": sd["encoder_local.node_emb.weight"]},
            **{f"convs_{i}": {"nn": {f"layers_{j}": dense(f"encoder_local.convs.{i}.nn.layers.{j}")
                                     for j in range(2)}}
               for i in range(model["num_convs_local"])},
        },
        "grad_global_dist_mlp": mlp3("grad_global_dist_mlp"),
        "grad_local_dist_mlp": mlp3("grad_local_dist_mlp"),
    }
    if model.get("TS", False):
        for side in ("global", "local"):
            params[f"edge_cat_{side}"] = {"lin0": dense(f"edge_cat_{side}.0"),
                                          "lin1": dense(f"edge_cat_{side}.2")}
    return {"params": params}


def condensenc_state_dict_from_params(params: dict, num_convs: int) -> dict:
    """Inverse of :func:`condensenc_params_from_state_dict`: flax parameter
    tree -> reference state_dict (numpy, torch (out, in) weight layout), to
    write reference-format checkpoints."""
    p = params["params"] if "params" in params else params
    sd = {}

    def put_dense(prefix, d):
        sd[f"{prefix}.weight"] = _t(d["Dense_0"]["kernel"])
        if "bias" in d["Dense_0"]:
            sd[f"{prefix}.bias"] = np.asarray(d["Dense_0"]["bias"])

    sd["atom_embedding.weight"] = np.asarray(p["atom_embedding"]["embedding"])
    sd["atom_feat_embedding.weight"] = _t(p["atom_feat_embedding"]["Dense_0"]["kernel"])
    sd["edge_encoder.bond_emb.weight"] = np.asarray(p["edge_enc"]["bond_emb"]["embedding"])
    for i in range(2):
        put_dense(f"edge_encoder.mlp.layers.{i}", p["edge_enc"]["mlp"][f"layers_{i}"])
    put_dense("edge_cat.0", p["edge_cat"]["lin0"])
    put_dense("edge_cat.2", p["edge_cat"]["lin1"])
    st = p["encoder"]["stack"]
    for l in range(num_convs):
        conv = f"encoder.interactions.{l}.conv."
        sd[conv + "mlp.0.weight"] = _t(st["f1w"][l])
        sd[conv + "mlp.0.bias"] = np.asarray(st["f1b"][l])
        sd[conv + "mlp.2.weight"] = _t(st["f2w"][l])
        sd[conv + "mlp.2.bias"] = np.asarray(st["f2b"][l])
        sd[conv + "lin1.weight"] = _t(st["l1w"][l])
        sd[conv + "lin2.weight"] = _t(st["l2w"][l])
        sd[conv + "lin2.bias"] = np.asarray(st["l2b"][l])
        sd[f"encoder.interactions.{l}.lin.weight"] = _t(st["ow"][l])
        sd[f"encoder.interactions.{l}.lin.bias"] = np.asarray(st["ob"][l])
    for i in range(3):
        put_dense(f"grad_dist_mlp.layers.{i}", p["grad_dist_mlp"][f"layers_{i}"])
    return sd


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def convert_reference_checkpoint(pt_path: str, out_path: str | None = None) -> dict:
    """Load a reference ``<iter>.pt`` and emit a ``tsdiff_tpu.ckpt.v1``
    payload (written to ``out_path`` when given).  The embedded EasyDict
    config is flattened to plain dicts; the betas/alphas/sigmas buffers are
    dropped (the schedule is rebuilt from the config)."""
    from tsdiff_tpu_torch.data.torch_reader import load_torch_file

    ck = load_torch_file(pt_path)
    config = _plain(ck["config"])
    model_cfg = config["model"]
    network = model_cfg.get("network", "condensenc")
    sd = {
        k: np.asarray(v) for k, v in ck["model"].items()
        if not k.startswith(("betas", "alphas", "sigmas")) and not k.endswith(".eps")
    }
    if network.startswith("dualenc"):
        params = dualenc_params_from_state_dict(sd, config)
    else:
        params = condensenc_params_from_state_dict(sd,
                                                   num_convs=model_cfg["encoder"]["num_convs"])
    payload = {
        "format": "tsdiff_tpu.ckpt.v1",
        "config": config,
        "params": params,
        "opt_state": None,
        "scheduler": None,
        "iteration": int(ck.get("iteration", 0)),
        "avg_val_loss": ck.get("avg_val_loss"),
    }
    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    return payload


def graphs_from_pyg_list(data_list) -> list[dict]:
    """PyG ``Data`` objects (real or ``pyg_compat`` stubs) -> numpy graph
    dicts: atom_type, r_feat/p_feat one-hots, pos, condensed
    edge_index/edge_type, smiles, and the optional positions carried
    through (reference utils/datasets.py, ``generate_ts_data2``)."""
    from tsdiff_tpu_torch.data.pyg_compat import data_attrs

    graphs = []
    for d in data_list:
        a = data_attrs(d)
        g = dict(
            atom_type=np.asarray(a["atom_type"], dtype=np.int32),
            r_feat=np.asarray(a["r_feat"], dtype=np.float32),
            p_feat=np.asarray(a["p_feat"], dtype=np.float32),
            pos=np.asarray(a["pos"], dtype=np.float32),
            edge_index=np.asarray(a["edge_index"], dtype=np.int32),
            edge_type=np.asarray(a["edge_type"], dtype=np.int32),
            smiles=a.get("smiles"),
        )
        for opt in ("ts_guess", "pos_r", "pos_p", "pos_gen"):
            if opt in a:
                g[opt] = np.asarray(a[opt], dtype=np.float32)
        graphs.append(g)
    return graphs


def convert_reference_dataset(pkl_path: str, out_path: str) -> int:
    """Convert a reference PyG pickle (a dataset or a ``samples_all.pkl``)
    to a ``tsdiff_tpu.v1`` dataset; returns the number of graphs written."""
    from tsdiff_tpu_torch.data.dataset import save_dataset
    from tsdiff_tpu_torch.data.pyg_compat import load_pyg_pickle

    graphs = graphs_from_pyg_list(load_pyg_pickle(pkl_path))
    save_dataset(out_path, graphs)
    return len(graphs)


def main(argv=None):
    """``python -m tsdiff_tpu_torch.data.convert``: one-shot conversion of a
    reference artifact.  The sampling CLI, the service and ``--pretrain``
    also read reference ``.pt`` files and PyG pickles directly; converting
    keeps a converted copy on disk."""
    ap = argparse.ArgumentParser(description=main.__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    ck = sub.add_parser("ckpt", help="reference <iter>.pt -> tsdiff_tpu .ckpt")
    ck.add_argument("pt_path")
    ck.add_argument("out_path")
    ds = sub.add_parser("dataset", help="reference PyG pickle -> tsdiff_tpu dataset "
                        "(torch_geometric/rdkit not needed)")
    ds.add_argument("pkl_path")
    ds.add_argument("out_path")
    args = ap.parse_args(argv)
    if args.cmd == "ckpt":
        payload = convert_reference_checkpoint(args.pt_path, args.out_path)
        print(f"wrote {args.out_path}: iteration {payload['iteration']}, "
              f"network {payload['config']['model'].get('network', 'condensenc')}")
    else:
        n = convert_reference_dataset(args.pkl_path, args.out_path)
        print(f"wrote {args.out_path}: {n} graphs")


if __name__ == "__main__":
    main()
