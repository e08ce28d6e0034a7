"""Serving side of the port: prefill / decode steps with sampling, the
continuous batcher, and the spatio-temporal RAG pipeline — the
counterpart of ``repro.serving`` (the retrieval batcher, tenancy and the
service tier are ROADMAP Queue A item 11)."""
from .batching import ContinuousBatcher, Request
from .rag import Document, DocumentStore, RAGPipeline, RetrievedDocs
from .serve_step import generate, make_serve_fns, sample_logits

__all__ = ["ContinuousBatcher", "Request", "Document", "DocumentStore",
           "RAGPipeline", "RetrievedDocs", "generate", "make_serve_fns",
           "sample_logits"]
