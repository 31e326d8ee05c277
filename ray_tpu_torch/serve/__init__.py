"""ray_tpu_torch.serve — serving. This slice ports the LLM engine
(serve.llm); the serve control plane comes in a later slice."""
