"""RAG denoiser, audio frontend, TransMLP backbone and CFG wrappers; the SAG,
its transformer layers and the text towers (CLIP's, and a DeepSeek-V3 MoE
language model's); the FGD evaluator's pose encoder."""

from .audio_encoder import WavEncoder, audio_samples_for_frames
from .cfg import make_cfg_denoiser, make_guidance_schedule, scheduled_scale
from .clip_text import CLIPTextConfig, CLIPTextEncoder, quick_gelu
from .embedding_net import BeatEmbeddingEncoder, PoseEmbeddingEncoder, TedEmbeddingEncoder
from .moe_text import MoETextConfig, MoETextEncoder
from .mlp_backbone import MLPBlock, TimestepEmbedder, TransMLP, sinusoidal_table
from .rag import RAG, RAGConfig
from .sag import SAG, SAGDecoder, SAGEncoder, sag_losses
from .transformer import (
    MultiHeadAttention,
    TransformerDecoder,
    TransformerDecoderLayer,
    TransformerEncoder,
    TransformerEncoderLayer,
)
