"""The paper's experiment models (MLP, CNN) with parameters in JAX layout."""
