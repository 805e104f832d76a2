"""The host's input pipeline: VW text → parsed record → translated example →
padded batch. The parser, reader, translator and transforms are the port's
own copies of the JAX package's (``ingest/``); the names the port uses are
re-exported here."""

from .parser import FlushCommand, HogwildLoadCommand, VowpalParser
from .reader import create_buffered_input
from .translator import Batcher, FeatureTranslator, TranslatedExample

__all__ = ["Batcher", "FeatureTranslator", "FlushCommand", "HogwildLoadCommand",
           "TranslatedExample", "VowpalParser", "create_buffered_input"]
