"""Model zoo of the port: the dense GQA decoder (other families follow)."""
