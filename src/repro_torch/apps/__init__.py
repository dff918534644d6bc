"""The paper's two applications: predicate evaluation and GBDT inference."""
