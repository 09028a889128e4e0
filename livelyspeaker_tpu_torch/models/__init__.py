"""RAG denoiser, audio frontend, TransMLP backbone and CFG wrappers."""

from .audio_encoder import WavEncoder, audio_samples_for_frames
from .cfg import make_cfg_denoiser, make_guidance_schedule, scheduled_scale
from .mlp_backbone import MLPBlock, TimestepEmbedder, TransMLP, sinusoidal_table
from .rag import RAG, RAGConfig
