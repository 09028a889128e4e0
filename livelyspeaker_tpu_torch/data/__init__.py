"""Data pipeline: sharded records, loaders, TED and BEAT datasets, and the
CLIP tokenizers of the two-stage composition."""

from .clip_tokenizer import CLIPTokenizer, HashTokenizer, tokenize
from .loader import DataLoader, DeviceDataLoader
from .records import ShardedDataset, ShardWriter
from .ted import (
    PROMPT,
    MotionFilter,
    TedConfig,
    TedWindowDataset,
    build_ted_records,
    make_audio_fixed_length,
    resample_pose_seq,
    sample_windows_from_clip,
)
from .textgrid import Interval, Tier, parse_textgrid
from .vocab import Vocab, build_vocab
