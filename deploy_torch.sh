#!/usr/bin/env bash
# Deploy/undeploy the port's gpu-mounter (gpumounter_tpu_torch): deploy |
# redeploy | uninstall over the deploy_torch/ manifests, as the original's
# deploy.sh:8-40. The images are docker_torch/master and docker_torch/worker.
set -euo pipefail

MANIFESTS=(
  deploy_torch/namespace.yaml
  deploy_torch/rbac.yaml
  deploy_torch/worker-daemonset.yaml
  deploy_torch/master-deployment.yaml
  deploy_torch/service.yaml
)

ensure_auth_secret() {
  # The control plane's shared secret (fail-closed: the daemons refuse to
  # start without it). Made once and kept on redeploy, so that a rolling
  # restart keeps the operators' tokens valid.
  if ! kubectl -n kube-system get secret gpu-mounter-auth >/dev/null 2>&1; then
    kubectl -n kube-system create secret generic gpu-mounter-auth \
      --from-literal=token="$(openssl rand -hex 32)"
    echo "created Secret/gpu-mounter-auth (kube-system)"
  fi
  echo "control-plane token (for the CLI / curl):"
  echo "  kubectl -n kube-system get secret gpu-mounter-auth -o jsonpath='{.data.token}' | base64 -d"
}

deploy() {
  ensure_auth_secret
  for m in "${MANIFESTS[@]}"; do kubectl apply -f "$m"; done
  echo "gpu-mounter deployed. Label GPU nodes to opt in:"
  echo "  kubectl label node <node> gpu-mounter-enable=enable"
}

uninstall() {
  for ((i=${#MANIFESTS[@]}-1; i>=0; i--)); do
    kubectl delete -f "${MANIFESTS[$i]}" --ignore-not-found
  done
  kubectl -n kube-system delete secret gpu-mounter-auth --ignore-not-found
}

case "${1:-}" in
  deploy)    deploy ;;
  redeploy)  uninstall; deploy ;;
  uninstall) uninstall ;;
  *) echo "usage: $0 deploy|redeploy|uninstall" >&2; exit 2 ;;
esac
