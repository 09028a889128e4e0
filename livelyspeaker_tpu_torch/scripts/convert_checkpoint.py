"""Convert a reference PyTorch checkpoint into the portable npz.

Port of the JAX package's ``scripts/convert_checkpoint.py``:

    python -m livelyspeaker_tpu_torch.scripts.convert_checkpoint rag ckpts/TED/RAG.pt rag_ted.npz

Kinds:
  rag       ckpts/TED/RAG.pt or a BEAT RAG checkpoint (a plain state_dict,
            CLIP stripped); ``--layers``, and ``--num_emotions 8`` for BEAT
  sag       ckpts/TED/SAG.pth (the MotionCLIP state_dict)
  clip      OpenAI CLIP ViT-B/32 (the whole model or its state_dict; the
            text tower is kept)
  fgd       the TED TriModal gesture autoencoder (gesture_autoencoder_*.bin)
  beat_fid  BEAT's HalfEmbeddingNet (best_rec_200.bin); its encoder is all
            the FID reads

The reference state_dict goes to the port's modules
(``utils/convert.py``), then out as the JAX package's flat npz
(``training/checkpoints.save_params_npz``): the file that ``scripts/serve.py``,
``train_*`` and the eval scripts of both packages read. Nothing here runs
on the card.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import torch

__all__ = ["main", "convert"]

KINDS = ("rag", "sag", "clip", "fgd", "beat_fid")


def load_torch(path: str):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return obj


def convert(kind: str, sd, layers: int = 8, num_emotions: int = 0):
    """(the port's state_dict, a module of its tree) for a reference
    state_dict ``sd`` of ``kind``; the module names each leaf's layout for
    ``save_params_npz``."""
    from ..models import SAG, CLIPTextEncoder, RAG, RAGConfig
    from ..models.embedding_net import BeatEmbeddingEncoder, TedEmbeddingEncoder
    from ..utils import convert as cv

    if kind == "rag":
        state = cv.rag_state_dict_from_reference(sd, num_layers=layers,
                                                 num_emotions=num_emotions)
        return state, RAG(RAGConfig(num_layers=layers, num_emotions=num_emotions))
    if kind == "sag":
        return cv.sag_state_dict_from_reference(sd), SAG()
    if kind == "clip":
        return cv.clip_text_state_dict_from_openai(sd), CLIPTextEncoder()
    # fgd / beat_fid: one PoseEncoderConv converter, as in the JAX script
    inner = sd.get("gen_dict") or sd.get("model_state") or sd
    net = BeatEmbeddingEncoder() if kind == "beat_fid" else TedEmbeddingEncoder()
    return cv.pose_embedding_state_dict_from_torch(inner), net


def main(argv: Optional[List[str]] = None) -> Dict:
    """Convert as ``argv`` says; returns the state_dict written."""
    from ..training.checkpoints import save_params_npz

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("kind", choices=KINDS)
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--layers", type=int, default=8, help="RAG mixer blocks")
    p.add_argument("--num_emotions", type=int, default=0,
                   help="8 for BEAT RAG checkpoints")
    args = p.parse_args(argv)

    state, model = convert(args.kind, load_torch(args.src), args.layers, args.num_emotions)
    save_params_npz(args.dst, state, model)
    print(f"converted {args.kind}: {args.src} -> {args.dst}")
    return state


if __name__ == "__main__":
    main()
