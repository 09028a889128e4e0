"""Text front end of the two-stage composition: the CLIP tokenizers."""

from .clip_tokenizer import CLIPTokenizer, HashTokenizer, tokenize
