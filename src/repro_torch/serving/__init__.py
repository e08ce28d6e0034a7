"""Serving side of the port: prefill / decode steps with sampling, the
continuous batcher, the spatio-temporal RAG pipeline, and the multi-tenant
serving tier (retrieval batcher, tenant collections, admission control,
continuous filtered batching and the geo-temporal traffic harness) — the
counterpart of ``repro.serving``."""
from .batching import (ContinuousBatcher, Request, RetrievalBatcher,
                       RetrievalFailure, RetrievalRequest)
from .rag import Document, DocumentStore, RAGPipeline, RetrievedDocs
from .serve_step import generate, make_serve_fns, sample_logits
from .service import (AdmissionController, CubeGraphService, ServeRequest,
                      ServeResult)
from .tenancy import (Collection, MultiTenantStore, TenantAnswer,
                      TenantIsolationError, TenantQuotaError)

__all__ = ["ContinuousBatcher", "Request", "RetrievalBatcher",
           "RetrievalFailure", "RetrievalRequest", "Document",
           "DocumentStore", "RAGPipeline", "RetrievedDocs", "generate",
           "make_serve_fns", "sample_logits", "AdmissionController",
           "CubeGraphService", "ServeRequest", "ServeResult", "Collection",
           "MultiTenantStore", "TenantAnswer", "TenantIsolationError",
           "TenantQuotaError"]
