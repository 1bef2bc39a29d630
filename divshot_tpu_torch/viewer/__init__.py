"""The live viewer's page and server."""
